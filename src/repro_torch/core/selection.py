"""Client selection: Algorithm 2 lines 6-10.

1. RA  = CheckResource(...)                      (resource mask)
2. S   = sort eligible clients by (trust, RA)    (descending)
3. C   = top floor(|S| * F) of S
4. M_m = random subset of C                      (participants)

The random subset is a uniform choice without replacement by Gumbel top-k.
Both sorts are stable, as the reference's ``jnp.argsort`` is: trust scores
start equal and ``resource_score`` caps at 4.0, so ties are common and an
unstable sort would pick a different candidate pool.

``sample_cohort`` is the host-side selection of the cohort engine over the
numpy client store (``core/client_store.py``): the same CheckResource,
trust-sorted pool and uniform draw, returning K client indices (a
static-shape cohort) instead of an (N,) mask.  It finds the pool by an O(N)
float32 value partition, not a sort, and is bit-equal to the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.config import FedConfig
from repro_torch.core.resources import (
    ResourceState,
    TaskRequirement,
    check_resource,
    resource_score,
)
from repro_torch.core.trust import TrustState, eligible


def select_clients(
    gumbel: torch.Tensor,
    trust: TrustState,
    res: ResourceState,
    req: TaskRequirement,
    fed: FedConfig,
    *,
    num_participants: int | None = None,
):
    """Returns (selected mask (N,) bool, eligible mask (N,) bool).

    ``gumbel`` is this round's (N,) standard Gumbel draw from the engine's
    draw provider.  ``num_participants`` defaults to
    ``max(1, floor(N * F))``; an ineligible client is never selected because
    its sort key is -inf."""
    N = trust.score.shape[0]
    ok = check_resource(res, req) & eligible(trust, fed)

    if num_participants is None:
        num_participants = max(1, int(N * fed.client_fraction))
    k = num_participants

    # composite sort key: trust primary, resource headroom secondary;
    # "random" baseline: uniform among resource-eligible clients
    if fed.selection == "random":
        score = torch.zeros_like(trust.score)
    else:
        score = trust.score + 0.01 * resource_score(res, req)
    score = torch.where(ok, score, -torch.inf)

    # top S*F candidate pool, then a uniform subset of size k within it
    pool_size = min(N, max(k, int(N * fed.client_fraction)))
    order = torch.argsort(-score, stable=True)
    pool_mask = torch.zeros(N, dtype=torch.bool, device=ok.device)
    pool_mask[order[:pool_size]] = True
    pool_mask &= ok

    pick_key = torch.where(pool_mask, gumbel, -torch.inf)
    chosen = torch.argsort(-pick_key, stable=True)[:k]
    selected = torch.zeros(N, dtype=torch.bool, device=ok.device)
    selected[chosen] = True
    return selected & pool_mask, ok


def sample_cohort(
    trust_score: np.ndarray,
    res,
    req: TaskRequirement,
    fed: FedConfig,
    *,
    cohort_size: int,
    round_idx: int,
):
    """Sample one round's static-shape cohort of ``cohort_size`` clients
    over the host store's numpy columns (``res``: ``HostResources``).

    CheckResource and the trust floor gate eligibility; the candidate pool
    is the top ``max(cohort_size, N * client_fraction)`` clients by trust +
    0.01 resource headroom (the eligible set itself under the "random"
    baseline); the cohort is a uniform draw without replacement from the
    pool, keyed on ``(fed.seed, round_idx)`` alone, so a run resumed from a
    store checkpoint replays the same cohorts.  Fewer eligible clients than
    ``cohort_size`` underfill the cohort (``valid`` False slots).

    Returns ``(idx, valid, eligible)``: (K,) int64 sorted client indices
    (underfill slots hold 0), the (K,) bool slot mask and the (N,) bool
    eligibility mask."""
    trust_score = np.asarray(trust_score)
    n = trust_score.shape[0]
    ok = (
        (np.asarray(res.memory) >= req.memory)
        & (np.asarray(res.bandwidth) >= req.bandwidth)
        & (np.asarray(res.battery) >= req.battery)
        # an exactly-dead client never passes CheckResource
        & (np.asarray(res.battery) > 0.0)
        & (trust_score >= fed.min_trust)
    )
    pool_size = min(n, max(cohort_size, int(n * fed.client_fraction)))
    if fed.selection == "random" or pool_size >= n:
        pool = np.flatnonzero(ok)
    else:
        # float32 throughout (python-float scalars do not promote)
        headroom = (
            np.minimum(np.asarray(res.memory) / req.memory, 4.0)
            + np.minimum(np.asarray(res.bandwidth) / req.bandwidth, 4.0)
            + np.minimum(np.asarray(res.battery) / max(req.battery, 1e-6),
                         4.0)
        ) / 3.0
        score = np.where(ok, trust_score + np.float32(0.01) * headroom,
                         -np.inf).astype(np.float32, copy=False)
        # top pool_size by VALUE partition: threshold at the pool_size-th
        # largest score, everything above it, then the threshold's ties in
        # index order.  The draw below is uniform within the pool, so only
        # membership matters, not order.
        kth = np.partition(score, n - pool_size)[n - pool_size]
        cand = np.flatnonzero(score > kth)
        if cand.size < pool_size:
            ties = np.flatnonzero(score == kth)
            cand = np.concatenate([cand, ties[: pool_size - cand.size]])
        pool = cand[ok[cand]]

    take = min(cohort_size, pool.size)
    rng = np.random.default_rng(np.random.SeedSequence([fed.seed, int(round_idx)]))
    idx = np.zeros(cohort_size, np.int64)
    valid = np.zeros(cohort_size, bool)
    if take:
        idx[:take] = np.sort(rng.choice(pool, size=take, replace=False))
        valid[:take] = True
    return idx, valid, ok
