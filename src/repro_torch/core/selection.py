"""Client selection: Algorithm 2 lines 6-10.

1. RA  = CheckResource(...)                      (resource mask)
2. S   = sort eligible clients by (trust, RA)    (descending)
3. C   = top floor(|S| * F) of S
4. M_m = random subset of C                      (participants)

The random subset is a uniform choice without replacement by Gumbel top-k.
Both sorts are stable, as the reference's ``jnp.argsort`` is: trust scores
start equal and ``resource_score`` caps at 4.0, so ties are common and an
unstable sort would pick a different candidate pool.
"""
from __future__ import annotations

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
