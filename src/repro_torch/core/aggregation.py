"""Server-side aggregation (§III.B.7, Algorithm 2 lines 13-14) over stacked
flat client updates (N, D).

Modes on this slice:
  fedavg -- synchronous FedAvg: wait for everyone (stragglers included);
            round time = max(latency).
  fedar  -- the paper: aggregate arrivals within timeout t, skip
            stragglers; round time = t.

The weighted reduction routes through the ``fedavg_agg`` CUDA kernel on the
card (``impl`` = ``FedConfig.agg_impl``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fedavg_agg import fedavg_agg
from repro_torch.kernels.ops import resolve_impl


def deviation_mask(deltas: torch.Tensor, active: torch.Tensor, gamma: float):
    """The paper's ban trigger ``G^i - D_m^i > gamma``: robust z-score of
    each client's update distance from the active-population mean.
    deltas (N, D), active (N,) bool -> (N,) bool deviated."""
    w = active.to(torch.float32)[:, None]
    mean = (deltas * w).sum(0) / torch.clamp(w.sum(), min=1.0)
    dist = torch.linalg.vector_norm(deltas - mean, dim=1)
    act_dist = torch.where(active, dist, torch.nan)
    mu = torch.nanmean(act_dist)
    sd = torch.sqrt(torch.nanmean((act_dist - mu) ** 2) + 1e-12)
    return active & (dist > mu + gamma * sd)


def staleness_weight(staleness):
    """FedAsync poly decay: s(tau) = (1 + tau)^-0.5."""
    return (1.0 + staleness) ** -0.5


def fedavg_aggregate(global_flat, deltas, weights, mask, *, staleness=None,
                     impl: str = "einsum"):
    """w <- w + sum_m mask_m * weight_m * s(tau_m) * delta_m / sum(...).

    ``staleness``: optional (N,) rounds-late per update, poly-decayed as
    ``(1 + tau)^-0.5``.  ``impl`` picks the reduction: the ``fedavg_agg``
    kernel or its plain version (``kernels.ops.resolve_impl``)."""
    w = weights * mask.to(weights.dtype)
    decay = 1.0 if staleness is None else staleness_weight(staleness)
    denom = torch.clamp((w * decay).sum(), min=1e-9)
    if resolve_impl(impl, "agg", deltas.device) == "kernel":
        num = fedavg_agg(deltas, w, staleness=staleness)
    else:
        num = ref.fedavg_agg_ref(deltas, w, staleness)
    return global_flat + num / denom
