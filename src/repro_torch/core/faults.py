"""Fault injection (selected by ``FedConfig.faults``).

FedAR's premise is that clients misbehave: they "infuse incorrect models or
repeatedly give slow responses".  A named schedule owns a deterministic
per-round fault draw that the engine's round consumes:

  ``crash``   -- a selected client dies mid-round: its uplink is lost
                 (exact-zero aggregation weight), but the battery it burned
                 and the trust penalty for the missed deadline still land.
  ``corrupt`` -- a fixed subset of clients (``fault_corrupt_frac``) sends
                 NaN / Inf / huge-but-finite rows, which the engine's
                 non-finite quarantine must absorb.
  ``battery`` -- periodic battery-death windows: the client reads as dead
                 to CheckResource for ``fault_battery_rounds`` of every
                 ``4 * fault_battery_rounds`` rounds.
  ``flaky``   -- flapping connectivity: ``fault_flap_rounds`` offline of
                 every ``fault_flap_period`` rounds, with a per-client phase.
  ``chaos``   -- all of the above at once.

The static traits (who can corrupt, whose battery dies, the phases) are
numpy picks from ``SeedSequence([seed, FAULT_KEY_FOLD, domain])`` in client
order, bit-identical to the reference's.  The per-round coins are one
(N, 2) uniform table from the engine's draw provider
(``convert.GeneratorDraws.fault_coins``; the parity tests replay the
reference's threefry table), indexed by client id.  ``faults="none"`` takes
no draw at all, so the fault-free round is unchanged bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.common.config import FedConfig

__all__ = ["FaultDraw", "FaultSchedule", "NoFaults", "SeededFaults",
           "make_faults", "FAULT_KEY_FOLD"]

# domain separator of the fault stream (the reference folds it into the
# round key before drawing the coin table)
FAULT_KEY_FOLD = 0xFA017

# values corrupt clients write over their delta rows, cycled per client:
# the quarantine must catch non-finite AND huge-but-finite garbage
_FILL_VALUES = (np.nan, np.inf, -np.inf, 1e32)


class FaultDraw(NamedTuple):
    """One round's fault realization over ``client_ids``."""

    crash: torch.Tensor  # (N,) bool: dies mid-round if selected
    corrupt: torch.Tensor  # (N,) bool: uplink rows replaced with garbage
    fill: torch.Tensor  # (N,) float32: the garbage value a corruptor writes
    unavailable: torch.Tensor  # (N,) bool: offline this round (CheckResource)


class FaultSchedule:
    """What the engine's round reads; ``active=False`` means the engine
    takes no draw and skips every fault branch."""

    name = "none"
    active = False

    def draw(self, coins, client_ids, round_idx: int) -> FaultDraw:
        raise NotImplementedError


class NoFaults(FaultSchedule):
    """No injection; the engine never calls ``draw``."""


class SeededFaults(FaultSchedule):
    """Deterministic seeded schedule; which fault kinds fire is the only
    difference between the named schedules.  The trait tables live on
    ``device``."""

    active = True

    def __init__(self, fed: FedConfig, *, crash: bool, corrupt: bool,
                 battery: bool, flaky: bool, device="cpu"):
        n = self.num_clients = fed.num_clients
        self.name = fed.faults
        self.crash_rate = float(fed.fault_crash_rate) if crash else 0.0
        self.corrupt_rate = float(fed.fault_corrupt_rate) if corrupt else 0.0
        self.flap_period = max(1, int(fed.fault_flap_period))
        self.flap_rounds = int(fed.fault_flap_rounds)
        self.batt_rounds = max(1, int(fed.fault_battery_rounds))

        def pick(frac: float, domain: int) -> np.ndarray:
            """Exact-count trait mask in client order."""
            rng = np.random.default_rng(
                np.random.SeedSequence([fed.seed, FAULT_KEY_FOLD, domain]))
            mask = np.zeros(n, bool)
            k = max(1, int(round(frac * n)))
            mask[rng.permutation(n)[:k]] = True
            return mask

        def dev(a):
            return torch.as_tensor(a, device=device)

        rng = np.random.default_rng(
            np.random.SeedSequence([fed.seed, FAULT_KEY_FOLD, 0]))
        self.corrupt_clients = (pick(fed.fault_corrupt_frac, 1)
                                if corrupt else np.zeros(n, bool))
        fill = np.asarray(_FILL_VALUES, np.float32)[np.arange(n)
                                                    % len(_FILL_VALUES)]
        self._fill = dev(np.where(self.corrupt_clients, fill,
                                  np.float32(0.0)).astype(np.float32))
        self._corrupt_trait = dev(self.corrupt_clients)

        self.flap_clients = (pick(fed.fault_flap_frac, 2)
                             if flaky else np.zeros(n, bool))
        self._flap_trait = dev(self.flap_clients)
        self._flap_phase = dev(
            rng.integers(0, self.flap_period, n).astype(np.int32))

        self.battery_clients = (pick(fed.fault_battery_frac, 3)
                                if battery else np.zeros(n, bool))
        self._batt_trait = dev(self.battery_clients)
        self._batt_phase = dev(
            rng.integers(0, 4 * self.batt_rounds, n).astype(np.int32))

    def draw(self, coins, client_ids, round_idx: int) -> FaultDraw:
        """This round's realization.  ``coins`` is the round's (N, 2)
        uniform table over the whole fleet; ``client_ids`` index it and the
        trait tables, so any slice of ids reads the coins the full draw
        gives those clients."""
        u = coins[client_ids]
        crash = u[:, 0] < self.crash_rate
        corrupt = self._corrupt_trait[client_ids] & (u[:, 1] < self.corrupt_rate)
        flapping = self._flap_trait[client_ids] & (
            torch.remainder(round_idx + self._flap_phase[client_ids],
                            self.flap_period) < self.flap_rounds)
        battery_dead = self._batt_trait[client_ids] & (
            torch.remainder(round_idx + self._batt_phase[client_ids],
                            4 * self.batt_rounds) < self.batt_rounds)
        return FaultDraw(
            crash=crash,
            corrupt=corrupt,
            fill=self._fill[client_ids],
            unavailable=flapping | battery_dead,
        )


_KINDS = {
    # name -> (crash, corrupt, battery, flaky)
    "crash": (True, False, False, False),
    "corrupt": (False, True, False, False),
    "battery": (False, False, True, False),
    "flaky": (False, False, False, True),
    "chaos": (True, True, True, True),
}


def make_faults(fed: FedConfig, device="cpu") -> FaultSchedule:
    """Build the schedule ``FedConfig.faults`` names."""
    if fed.faults == "none":
        return NoFaults()
    try:
        crash, corrupt, battery, flaky = _KINDS[fed.faults]
    except KeyError:
        raise ValueError(
            f"unknown FedConfig.faults={fed.faults!r} "
            f"(known: {sorted(_KINDS) + ['none']})"
        ) from None
    return SeededFaults(fed, crash=crash, corrupt=corrupt, battery=battery,
                        flaky=flaky, device=device)
