"""FoolsGold sybil/poisoning mitigation (§III.B.6): the similarity math.

Clients that repeatedly send *similar* updates get their aggregation weight
scaled down.  Two weightings share the (N, N) cosine block here (strategy
selection and history sketching live in ``core/defense.py``):

``foolsgold_weights``
    Fung et al.'s statistic: max pairwise cosine over the historical
    updates, pardoning, then logit re-scaling.
``cluster_weights``
    The cluster-aware variant: each client's effective cluster
    multiplicity ``m_i = 1 + sum_j relu(cs_ij)^power`` against
    ``slack * median_active(m)``; larger cliques decay as
    ``(slack * median / m)^sharpness``.

The block product goes through the ``sketch_similarity`` CUDA kernel on the
card (``impl`` = ``FedConfig.defense_impl``).  Written against
``ClientComms``, it is a gathered block product on a client mesh: each
rank row-normalizes its history block, the unit rows travel through
``gather_defense``, and each rank computes only its (N_loc, N) block; the
(N,) statistics (``maxcs``, the multiplicities) are all-gathered, and the
median stays on the replicated vector.  With identity comms this is the
dense one-device math.
"""
from __future__ import annotations

import torch

from repro_torch.core.distributed import IDENTITY, ClientComms
from repro_torch.kernels import ref
from repro_torch.kernels.defense_sim import sketch_similarity
from repro_torch.kernels.ops import resolve_impl


def _similarity_block(history, active, *, comms: ClientComms = IDENTITY,
                      impl: str):
    """Row-normalize this rank's history block, gather the unit rows, and
    return the masked (N_loc, N) cosine block (self-similarity zeroed at
    the rank's row offset, inactive pairs at -1)."""
    N = active.shape[0]
    n_loc = history.shape[0]
    norm = torch.linalg.vector_norm(history, dim=1, keepdim=True)
    unit = history / torch.clamp(norm, min=1e-9)
    unit_full = comms.gather_defense(unit)  # (N, d): the one all-to-all
    if resolve_impl(impl, "defense", history.device) == "kernel":
        cs = sketch_similarity(unit, unit_full)
    else:
        cs = ref.sketch_similarity_ref(unit, unit_full)
    rows = torch.arange(n_loc, device=cs.device) + comms.rank * n_loc
    cs = cs - (rows[:, None] == torch.arange(N, device=cs.device)[None, :]).to(cs.dtype)
    return torch.where(comms.local(active)[:, None] & active[None, :], cs, -1.0)


def foolsgold_weights(history: torch.Tensor, active: torch.Tensor, *,
                      comms: ClientComms = IDENTITY,
                      impl: str = "einsum") -> torch.Tensor:
    """history (N_loc, D) this rank's per-client cumulative updates; active
    (N,) bool.  Returns (N,) aggregation weights in [0, 1], replicated."""
    cs = _similarity_block(history, active, comms=comms, impl=impl)
    active_loc = comms.local(active)
    maxcs_loc = cs.max(dim=1).values  # v_i of this rank's rows
    maxcs = comms.all_gather(maxcs_loc)  # v_j of every column
    # pardoning: if v_j > v_i, rescale cs_ij by v_i / v_j
    ratio = maxcs_loc[:, None] / torch.clamp(maxcs[None, :], min=1e-9)
    cs = torch.where(maxcs[None, :] > maxcs_loc[:, None], cs * ratio, cs)
    wv = 1.0 - cs.max(dim=1).values
    wv = torch.clamp(wv, 0.0, 0.99)
    # logit re-scaling (kappa = 0.5 midpoint as in the paper's release)
    logit = torch.log(wv / torch.clamp(1.0 - wv, min=1e-9) + 1e-9) + 0.5
    wv = torch.clamp(logit, 0.0, 1.0)
    return comms.all_gather(torch.where(active_loc, wv, 0.0))


def cluster_weights(history: torch.Tensor, active: torch.Tensor, *,
                    comms: ClientComms = IDENTITY, impl: str = "einsum",
                    power: float = 8.0, slack: float = 5.0,
                    sharpness: float = 3.0) -> torch.Tensor:
    """Cluster-aware weighting over a (sketched) history block:
    ``w_i = clip(slack * median / m_i, 0, 1) ** sharpness``.  The median
    over the active clients averages the two middle values on an even
    count (``torch.nanquantile``; ``torch.nanmedian`` would take the lower
    one), and an empty round gives the neutral scale 1."""
    cs = _similarity_block(history, active, comms=comms, impl=impl)
    active_loc = comms.local(active)
    m_loc = 1.0 + (torch.clamp(cs, 0.0, 1.0) ** power).sum(dim=1)
    m = comms.all_gather(m_loc)  # (N,) replicated multiplicities
    med = torch.nanquantile(torch.where(active, m, torch.nan), 0.5)
    med = torch.nan_to_num(med, nan=1.0)
    wv = torch.clamp(slack * med / torch.clamp(m_loc, min=1.0), 0.0, 1.0) ** sharpness
    return comms.all_gather(torch.where(active_loc, wv, 0.0))


def update_history(history, deltas, active, *, decay: float = 1.0,
                   comms: ClientComms = IDENTITY):
    """Accumulate the deltas of the ``active`` clients into the similarity
    history (both this rank's blocks; ``active`` replicated); ``decay`` < 1
    forgets old rounds exponentially."""
    return decay * history + torch.where(comms.local(active)[:, None], deltas, 0.0)
