"""Host-side client store: the fleet table the cohort engine samples.

The resident engine keeps every client's trust, battery and defense history
on the device, which caps the fleet at what the card holds.  The store keeps
all O(N * smallstate) bookkeeping in numpy columns on the host instead: the
trust score and the Algorithm 1 participation / failure counters, the
resource model (memory / bandwidth / battery / compute), the (sketched)
defense history rows, the error-feedback residual and the buffered-async
slot of each client, and ``last_selected``.  Each round the cohort engine

  1. samples a static-shape cohort of K clients (``selection.sample_cohort``),
  2. gathers only those K rows (``gather``) and moves them to the device,
  3. runs the unchanged round body at cohort scope,
  4. writes the updated rows back (``scatter_round``) and evolves everyone
     else on the host (``finish_round``: C_Interested for the eligible but
     not sampled, the idle battery trickle).

The table is split into ``num_shards`` contiguous blocks (``block``), the
O(N / num_shards) slice a multi-host registry would own.  ``state_dict`` /
``load_state_dict`` round-trip the whole table through
``checkpoint/ckpt.py`` (``save_store`` / ``restore_store``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.common.config import FedConfig
from repro_torch.core.resources import BATTERY_COST, make_fleet
from repro_torch.core.trust import TrustState


class HostResources(NamedTuple):
    """Numpy view of the store's resource columns (``ResourceState``'s
    fields, for the host-side selection)."""

    memory: np.ndarray
    bandwidth: np.ndarray
    battery: np.ndarray
    compute: np.ndarray


# the array-valued columns a checkpoint must round-trip, in one place so
# state_dict / load_state_dict / block / gather cannot drift apart
_COLUMNS = (
    "score", "participations", "failures",
    "memory", "bandwidth", "battery", "compute",
    "history", "residual", "last_selected",
    # the buffered-async slot of each client (aggregation="async"): the
    # in-flight delta and its weight / issue / arrival / valid tags follow
    # the client on and off the device (zero-width otherwise)
    "pending_delta", "pending_weight", "pending_issued",
    "pending_arrival", "pending_valid",
)
_PENDING = ("pending_delta", "pending_weight", "pending_issued",
            "pending_arrival", "pending_valid")


class ClientStore:
    """Numpy-backed per-client table; O(N * smallstate) host memory, plus
    O(N * D) when the residual or pending columns have width D."""

    def __init__(self, fed: FedConfig, history_dim: int, *,
                 residual_dim: int = 0, pending_dim: int = 0,
                 num_shards: int = 1):
        n = fed.num_clients
        if num_shards < 1 or n % num_shards:
            raise ValueError(
                f"num_clients={n} must divide into num_shards={num_shards} "
                f"contiguous store blocks"
            )
        self.fed = fed
        self.num_shards = num_shards
        res, self.poison_mask = make_fleet(
            n, num_starved=fed.num_starved, num_poisoners=fed.num_poisoners,
            seed=fed.seed,
        )
        self.score = np.full(n, fed.c_initial, np.float32)
        self.participations = np.zeros(n, np.int32)
        self.failures = np.zeros(n, np.int32)
        self.memory = res.memory.numpy().copy()
        self.bandwidth = res.bandwidth.numpy().copy()
        self.battery = res.battery.numpy().copy()
        self.compute = res.compute.numpy().copy()
        self.history = np.zeros((n, history_dim), np.float32)
        self.residual = np.zeros((n, residual_dim), np.float32)
        self.last_selected = np.full(n, -1, np.int32)
        self.pending_delta = np.zeros((n, pending_dim), np.float32)
        self.pending_weight = np.zeros(n, np.float32)
        self.pending_issued = np.zeros(n, np.int32)
        self.pending_arrival = np.zeros(n, np.int32)
        self.pending_valid = np.zeros(n, bool)
        self.round_idx = np.zeros((), np.int32)

    @property
    def num_clients(self) -> int:
        return self.score.shape[0]

    @property
    def history_dim(self) -> int:
        return self.history.shape[1]

    @property
    def residual_dim(self) -> int:
        return self.residual.shape[1]

    @property
    def pending_dim(self) -> int:
        return self.pending_delta.shape[1]

    @property
    def nbytes(self) -> int:
        """Host bytes of every column."""
        return sum(getattr(self, name).nbytes for name in _COLUMNS)

    def block(self, shard: int) -> dict:
        """Shard ``shard``'s contiguous column views (zero-copy): clients
        ``[shard * N/k, (shard + 1) * N/k)``."""
        if not 0 <= shard < self.num_shards:
            raise IndexError(
                f"shard {shard} out of range for {self.num_shards} blocks"
            )
        blk = self.num_clients // self.num_shards
        sl = slice(shard * blk, (shard + 1) * blk)
        return {name: getattr(self, name)[sl] for name in _COLUMNS}

    def trust_view(self) -> TrustState:
        return TrustState(self.score, self.participations, self.failures)

    def resources_view(self) -> HostResources:
        return HostResources(self.memory, self.bandwidth, self.battery,
                             self.compute)

    def gather(self, idx) -> dict:
        """Copies of the cohort's rows of every column but
        ``last_selected``: what moves to the device each round."""
        idx = np.asarray(idx)
        return {name: getattr(self, name)[idx] for name in _COLUMNS
                if name != "last_selected"}

    def scatter_round(self, idx, valid, *, trust: TrustState, battery,
                      history, residual=None, pending=None) -> None:
        """Write the round's results back: only the ``valid`` cohort slots
        land (underfill slots carry rows gathered from client 0).
        ``pending`` is the optional dict of post-round async columns, keyed
        like the store's."""
        keep = np.asarray(valid, bool)
        idx = np.asarray(idx)[keep]
        self.score[idx] = np.asarray(trust.score)[keep]
        self.participations[idx] = np.asarray(trust.participations)[keep]
        self.failures[idx] = np.asarray(trust.failures)[keep]
        self.battery[idx] = np.asarray(battery)[keep]
        if self.history_dim:
            self.history[idx] = np.asarray(history)[keep]
        if self.residual_dim and residual is not None:
            self.residual[idx] = np.asarray(residual)[keep]
        if self.pending_dim and pending is not None:
            for name in _PENDING:
                getattr(self, name)[idx] = np.asarray(pending[name])[keep]

    def finish_round(self, idx, valid, eligible) -> None:
        """Host-side evolution of the clients outside the cohort, as the
        resident round does it: the eligible but not sampled earn
        ``c_interested``, every client outside the cohort recharges
        ``BATTERY_COST / 4``, and the cohort's ``last_selected`` and the
        round counter advance."""
        in_cohort = np.zeros(self.num_clients, bool)
        live = np.asarray(idx)[np.asarray(valid, bool)]
        in_cohort[live] = True
        interested = np.asarray(eligible, bool) & ~in_cohort
        self.score[interested] += np.float32(self.fed.c_interested)
        idle = ~in_cohort
        self.battery[idle] = np.minimum(self.battery[idle] + BATTERY_COST / 4,
                                        1.0)
        self.last_selected[live] = int(self.round_idx)
        self.round_idx = self.round_idx + np.int32(1)

    def state_dict(self) -> dict:
        """Every column and the round counter (the arrays themselves, not
        copies)."""
        out = {name: getattr(self, name) for name in _COLUMNS}
        out["round_idx"] = self.round_idx
        return out

    def load_state_dict(self, state: dict) -> None:
        """Copy ``state`` (a ``state_dict``) into the store, checking every
        column's presence and shape."""
        for name in _COLUMNS:
            if name not in state:
                raise ValueError(
                    f"store checkpoint is missing column {name!r}; it was "
                    f"written without that column"
                )
            arr = np.asarray(state[name])
            if arr.shape != getattr(self, name).shape:
                raise ValueError(
                    f"store column {name!r}: checkpoint shape {arr.shape} "
                    f"vs store {getattr(self, name).shape}"
                )
            setattr(self, name, arr.astype(getattr(self, name).dtype))
        self.round_idx = np.asarray(state["round_idx"], np.int32).reshape(())
