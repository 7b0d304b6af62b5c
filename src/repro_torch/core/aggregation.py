"""Server-side aggregation (§III.B.7, Algorithm 2 lines 13-14) over stacked
flat client updates (N, D).

Modes:
  fedavg    -- synchronous FedAvg: wait for everyone (stragglers
               included); round time = max(latency).
  fedar     -- the paper: aggregate arrivals within timeout t, skip
               stragglers; round time = t.
  async     -- buffered no-wait (FedBuff-style): straggler updates wait in
               a per-client buffer and merge in a later round with a
               staleness-discounted weight; round time = t.  The buffer
               lives in ``core/engine.py``; the discounted reduction is
               ``fedavg_aggregate`` with ``staleness``.
  async_seq -- legacy FedAsync-style: fold local models one by one in
               arrival order (``async_aggregate``, O(N) sequential).

With compression on, the engine decodes each uplink before this boundary,
so every reduction here consumes the decoded rows.  The weighted reduction
routes through the ``fedavg_agg`` CUDA kernel on the card (``impl`` =
``FedConfig.agg_impl``).
"""
from __future__ import annotations

import torch

from repro_torch.common.config import FedConfig
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


def staleness_weight(staleness, fed: FedConfig | None = None):
    """FedAsync poly decay: s(tau) = (1 + tau)^-0.5; all ones when
    ``fed.staleness_decay`` is ``"const"``."""
    if fed is not None and fed.staleness_decay == "const":
        return torch.ones_like(staleness)
    return (1.0 + staleness) ** -0.5


def async_aggregate(global_flat, models, weights, mask, order, fed: FedConfig):
    """Fold client MODELS (not deltas) in arrival order:
        w <- (1 - a_m) w + a_m w_m,  a_m = alpha * weight_m / max(weight).
    ``order``: (N,) permutation by arrival time; masked-out entries mix
    with weight 0.  The models are the raw local models, not the
    quarantined deltas, so a non-finite model poisons the fold even at
    weight 0 (0 * NaN = NaN), as in the reference (R6 in ROADMAP.md)."""
    wnorm = weights / torch.clamp(weights.max(), min=1e-9)
    a_all = fed.staleness_alpha * wnorm * mask.to(torch.float32)
    g = global_flat
    for idx in order.tolist():
        a = a_all[idx]
        g = (1.0 - a) * g + a * models[idx]
    return g


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
