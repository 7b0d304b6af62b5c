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

Every reduction is written against the ``ClientComms`` vocabulary
(``core/distributed.py``): with the default identity comms this is the
one-device math; on a client mesh the ``(N, D)`` operands are the rank's
(N_loc, D) block, masks and weights stay replicated (N,), and the (D,)
partials cross the ranks through ``comms``.
"""
from __future__ import annotations

import torch

from repro_torch.common.config import FedConfig
from repro_torch.core.distributed import IDENTITY, ClientComms
from repro_torch.kernels import ref
from repro_torch.kernels.fedavg_agg import fedavg_agg
from repro_torch.kernels.ops import resolve_impl


def _cohort_rows(per_client, cohort):
    """(N,) per-client values -> the cohort rows' values; a slot that holds
    no genuinely selected client (``valid`` False) reads zero."""
    canon, valid = cohort
    return per_client[canon] * valid


def deviation_mask(deltas: torch.Tensor, active: torch.Tensor, gamma: float,
                   *, comms: ClientComms = IDENTITY, cohort=None):
    """The paper's ban trigger ``G^i - D_m^i > gamma``: robust z-score of
    each client's update distance from the active-population mean.
    deltas (N_loc, D) this rank's rows, active (N,) bool replicated ->
    (N,) bool deviated, replicated.  The population mean comes from ONE
    ``psum`` of the (D,) weighted-delta sum with the active count fused
    into a tail slot, the distances from one ``all_gather``.

    ``cohort=(canon, valid)``: selection-gated mode.  ``deltas`` holds only
    the gated cohort's rows, ``canon`` (C,) maps each row to its local
    client and ``valid`` (C,) marks the slots of genuinely selected
    clients.  Every other client's delta is an exact zero and never
    active, so the statistics are over the same population; only the fp32
    summation order shifts."""
    D = deltas.shape[1]
    act_loc = comms.local(active)
    act_rows = act_loc if cohort is None else _cohort_rows(act_loc, cohort)
    w = act_rows.to(torch.float32)[:, None]
    tot = comms.psum(torch.cat([(deltas * w).sum(0), w.sum().reshape(1)]))
    mean = tot[:D] / torch.clamp(tot[D], min=1.0)
    dist = torch.linalg.vector_norm(deltas - mean, dim=1)
    if cohort is not None:
        # back to client order: fill slots drop into a spare last entry,
        # clients outside the cohort read 0 (inactive, so never counted)
        canon, valid = cohort
        n = act_loc.shape[0]
        full = torch.zeros(n + 1, dtype=dist.dtype, device=dist.device)
        full[torch.where(valid, canon, n)] = dist
        dist = full[:n]
    dist = comms.all_gather(dist)  # (N,)
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


def async_aggregate(global_flat, models, weights, mask, order, fed: FedConfig,
                    *, comms: ClientComms = IDENTITY):
    """Fold client MODELS (not deltas) in arrival order:
        w <- (1 - a_m) w + a_m w_m,  a_m = alpha * weight_m / max(weight).
    ``order``: (N,) permutation by arrival time; masked-out entries mix
    with weight 0.  The fold is sequential over the global arrival order,
    so on a mesh the rank-local models are all-gathered first (this legacy
    mode does not scale; ``aggregation="async"`` does).  The models are the
    raw local models, not the quarantined deltas, so a non-finite model
    poisons the fold even at weight 0 (0 * NaN = NaN), as in the reference
    (R6 in ROADMAP.md)."""
    models = comms.all_gather(models)
    wnorm = weights / torch.clamp(weights.max(), min=1e-9)
    a_all = fed.staleness_alpha * wnorm * mask.to(torch.float32)
    g = global_flat
    for idx in order.tolist():
        a = a_all[idx]
        g = (1.0 - a) * g + a * models[idx]
    return g


def fedavg_aggregate(global_flat, deltas, weights, mask, *, staleness=None,
                     impl: str = "einsum", comms: ClientComms = IDENTITY,
                     cohort=None):
    """w <- w + sum_m mask_m * weight_m * s(tau_m) * delta_m / sum(...).

    ``staleness``: optional (N,) rounds-late per update, poly-decayed as
    ``(1 + tau)^-0.5``.  ``impl`` picks the reduction: the ``fedavg_agg``
    kernel or its plain version (``kernels.ops.resolve_impl``).  On a mesh
    ``deltas`` is the rank's (N_loc, D) block while ``weights`` / ``mask``
    / ``staleness`` stay replicated (N,): the denominator is taken on the
    full vectors, and the kernel's (D,) numerator over the local rows goes
    through ``comms.reduce_tree``.
    ``cohort=(canon, valid)``: ``deltas`` holds only the gated cohort's rows
    (see ``deviation_mask``); the numerator skips the known-zero rows."""
    w = weights * mask.to(weights.dtype)
    decay = 1.0 if staleness is None else staleness_weight(staleness)
    denom = torch.clamp((w * decay).sum(), min=1e-9)
    w = comms.local(w)
    if staleness is not None:
        staleness = comms.local(staleness)
    if cohort is not None:
        w = _cohort_rows(w, cohort)
        if staleness is not None:
            staleness = staleness[cohort[0]]
    if resolve_impl(impl, "agg", deltas.device) == "kernel":
        num = fedavg_agg(deltas, w, staleness=staleness)
    else:
        num = ref.fedavg_agg_ref(deltas, w, staleness)
    return global_flat + comms.reduce_tree(num) / denom
