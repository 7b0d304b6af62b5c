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
card (``impl`` = ``FedConfig.defense_impl``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.defense_sim import sketch_similarity
from repro_torch.kernels.ops import resolve_impl


def _similarity_block(history, active, *, impl: str):
    """Row-normalize the history and return the masked (N, N) cosine block
    (self-similarity zeroed, inactive pairs at -1)."""
    N = active.shape[0]
    norm = torch.linalg.vector_norm(history, dim=1, keepdim=True)
    unit = history / torch.clamp(norm, min=1e-9)
    if resolve_impl(impl, "defense", history.device) == "kernel":
        cs = sketch_similarity(unit, unit)
    else:
        cs = ref.sketch_similarity_ref(unit, unit)
    cs = cs - torch.eye(N, dtype=cs.dtype, device=cs.device)
    return torch.where(active[:, None] & active[None, :], cs, -1.0)


def foolsgold_weights(history: torch.Tensor, active: torch.Tensor, *,
                      impl: str = "einsum") -> torch.Tensor:
    """history (N, D) per-client cumulative updates; active (N,) bool.
    Returns (N,) aggregation weights in [0, 1]."""
    cs = _similarity_block(history, active, impl=impl)
    maxcs = cs.max(dim=1).values  # v_i
    # pardoning: if v_j > v_i, rescale cs_ij by v_i / v_j
    ratio = maxcs[:, None] / torch.clamp(maxcs[None, :], min=1e-9)
    cs = torch.where(maxcs[None, :] > maxcs[:, None], cs * ratio, cs)
    wv = 1.0 - cs.max(dim=1).values
    wv = torch.clamp(wv, 0.0, 0.99)
    # logit re-scaling (kappa = 0.5 midpoint as in the paper's release)
    logit = torch.log(wv / torch.clamp(1.0 - wv, min=1e-9) + 1e-9) + 0.5
    wv = torch.clamp(logit, 0.0, 1.0)
    return torch.where(active, wv, 0.0)


def cluster_weights(history: torch.Tensor, active: torch.Tensor, *,
                    impl: str = "einsum", power: float = 8.0,
                    slack: float = 5.0, sharpness: float = 3.0) -> torch.Tensor:
    """Cluster-aware weighting over a (sketched) history block:
    ``w_i = clip(slack * median / m_i, 0, 1) ** sharpness``.  The median
    over the active clients averages the two middle values on an even
    count (``torch.nanquantile``; ``torch.nanmedian`` would take the lower
    one), and an empty round gives the neutral scale 1."""
    cs = _similarity_block(history, active, impl=impl)
    m = 1.0 + (torch.clamp(cs, 0.0, 1.0) ** power).sum(dim=1)
    med = torch.nanquantile(torch.where(active, m, torch.nan), 0.5)
    med = torch.nan_to_num(med, nan=1.0)
    wv = torch.clamp(slack * med / torch.clamp(m, min=1.0), 0.0, 1.0) ** sharpness
    return torch.where(active, wv, 0.0)


def update_history(history, deltas, active, *, decay: float = 1.0):
    """Accumulate client deltas of the ``active`` clients into the
    similarity history; ``decay`` < 1 forgets old rounds exponentially."""
    return decay * history + torch.where(active[:, None], deltas, 0.0)
