"""Trust engine: Table I + Algorithm 1 of the paper, vectorized over the fleet.

State per client: trust score C_m, participation count, unsuccessful count.
``update_trust`` implements UpdateTrustScore over the whole population:

  * on-time model        -> C_Reward (+8), U_m^i = 0
  * late/no model        -> U_m^i = 1, then by lifetime failure rate:
        rate < 0.2           -> C_Penalty (-2)
        0.2 <= rate < 0.5    -> C_Blame  (-8)
        rate >= 0.5          -> C_Ban    (-16)
  * model deviation ||G^i - D_m^i|| > gamma  -> C_Ban (regardless of timing)
  * eligible-but-not-selected                -> C_Interested (+1)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.common.config import FedConfig


class TrustState(NamedTuple):
    score: torch.Tensor  # (N,) float32
    participations: torch.Tensor  # (N,) int32, rounds the client was selected
    failures: torch.Tensor  # (N,) int32, cumulative U_m


def init_trust(num_clients: int, fed: FedConfig, device) -> TrustState:
    return TrustState(
        score=torch.full((num_clients,), fed.c_initial, dtype=torch.float32,
                         device=device),
        participations=torch.zeros(num_clients, dtype=torch.int32, device=device),
        failures=torch.zeros(num_clients, dtype=torch.int32, device=device),
    )


def update_trust(
    state: TrustState,
    fed: FedConfig,
    *,
    selected: torch.Tensor,  # (N,) bool, participant this round
    on_time: torch.Tensor,  # (N,) bool, model arrived within timeout t
    deviated: torch.Tensor,  # (N,) bool, ||G - D_m|| > gamma
    interested: torch.Tensor,  # (N,) bool, eligible
) -> TrustState:
    succeeded = selected & on_time & ~deviated
    failed_round = selected & ~succeeded

    participations = state.participations + selected.to(torch.int32)
    failures = state.failures + failed_round.to(torch.int32)
    # lifetime failure rate (Algorithm 1: (1/i) sum_p U_m^p), float32
    rate = failures / torch.clamp(participations, min=1)

    delta = torch.zeros_like(state.score)
    delta = torch.where(succeeded, fed.c_reward, delta)
    late_delta = torch.where(
        rate < fed.penalty_band,
        fed.c_penalty,
        torch.where(rate < fed.blame_band, fed.c_blame, fed.c_ban),
    ).to(delta.dtype)
    delta = torch.where(selected & ~on_time & ~deviated, late_delta, delta)
    # deviation beyond gamma is an immediate ban event (Algorithm 1 line 11)
    delta = torch.where(selected & deviated, fed.c_ban, delta)
    delta = torch.where(interested & ~selected, fed.c_interested, delta)

    return TrustState(
        score=state.score + delta,
        participations=participations,
        failures=failures,
    )


def eligible(state: TrustState, fed: FedConfig) -> torch.Tensor:
    """Clients whose trust qualifies for task participation."""
    return state.score >= fed.min_trust
