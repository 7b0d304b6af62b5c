"""Pluggable robust defense (§III.B.6, selected by ``FedConfig.defense``).

A strategy owns a carried per-client history block (its width and its
per-round update, decay included) and a per-round ``weights`` statistic:

  ``none``              -- no carried history (N, 0), no re-weighting.
  ``foolsgold``         -- the paper's dense Fung et al. statistic over the
                           (N, D) cumulative update history.
  ``foolsgold_sketch``  -- cluster-aware variant over a count sketch of the
                           deltas, D -> r (r = ``defense_sketch_dim``).

On a client mesh (``core/distributed.py``) the history is the rank's
block: the sketched defense sketches only its local rows and its gather
ships (N, r), the dense one ships (N, D).
"""
from __future__ import annotations

import warnings
import weakref

import numpy as np
import torch

from repro_torch.common.config import FedConfig
from repro_torch.core import foolsgold as fg
from repro_torch.core.distributed import IDENTITY, ClientComms
from repro_torch.kernels.count_sketch import count_sketch, decode_tables, sketch_tables


class DefenseStrategy:
    """Interface the engine's round calls, strategy-agnostically.

    ``history_dim``    -- width of the carried per-client history block.
    ``update_history`` -- fold this round's deltas (N_loc, D) into the
                          history block (N_loc, d), both this rank's rows.
    ``weights``        -- (N,) aggregation weights in [0, 1], replicated,
                          or ``None`` when the strategy does not re-weight.
    ``cohort_compatible`` -- whether the per-client history is small enough
                          for the cohort engine's host store.
    """

    name = "none"
    cohort_compatible = True

    def history_dim(self, model_dim: int) -> int:
        return 0

    def update_history(self, history, deltas, active, *,
                       comms: ClientComms = IDENTITY):
        return history

    def weights(self, history, active, *, comms: ClientComms = IDENTITY):
        return None


class NoDefense(DefenseStrategy):
    """Aggregation weights pass through untouched."""


class FoolsGoldDefense(DefenseStrategy):
    """Dense Fung et al. re-weighting over the (N, D) update history; its
    (N, N) block product is ``sketch_similarity`` with K = D."""

    name = "foolsgold"
    cohort_compatible = False  # an O(N * D) host table would defeat the store

    def __init__(self, fed: FedConfig, model_dim: int, device):
        self.decay = fed.defense_history_decay
        self.impl = fed.defense_impl

    def history_dim(self, model_dim: int) -> int:
        return model_dim

    def update_history(self, history, deltas, active, *,
                       comms: ClientComms = IDENTITY):
        return fg.update_history(history, deltas, active, decay=self.decay,
                                 comms=comms)

    def weights(self, history, active, *, comms: ClientComms = IDENTITY):
        return fg.foolsgold_weights(history, active, comms=comms, impl=self.impl)


class _Tables:
    """A holder a weak reference can point at."""

    def __init__(self, tables):
        self.tables = tables


_SHARED = weakref.WeakValueDictionary()


class SketchedFoolsGold(DefenseStrategy):
    """Cluster-aware FoolsGold over a count-sketched (N, r) history.

    Coordinate d adds ``sign[d] * x[d]`` into bucket ``bucket[d]``.  The
    bucket and sign draws come from ``np.random.default_rng(seed +
    0x5EED)`` exactly as in the reference, so they are bit-identical to its
    tables; they are kept on the device as bucket-sorted chunk tables of
    2.25 bytes a coordinate (``kernels/count_sketch.py``, decoded again by
    the ``bucket`` and ``sign`` properties) and the host draws are freed.

    On the card the sketch is the ``count_sketch`` kernel, which sums each
    output in the tables' order, so two runs on the same rows are
    bit-equal (a scatter-add, ``index_add_``, adds in a varying order
    there, and a resumed run would then differ from an uninterrupted one);
    on the CPU it is the reference's scatter-add."""

    name = "foolsgold_sketch"

    def __init__(self, fed: FedConfig, model_dim: int, device):
        self.r = fed.defense_sketch_dim
        self.decay = fed.defense_history_decay
        self.impl = fed.defense_impl
        self.power = fed.defense_cluster_power
        self.slack = fed.defense_cluster_slack
        self.sharpness = fed.defense_cluster_sharpness
        # the tables depend on (seed, D, r) alone: engines of one model
        # (a route check's second engine, say) share them while one lives
        key = (fed.seed, model_dim, self.r, str(torch.device(device)))
        self._shared = _SHARED.get(key)
        if self._shared is None:
            rng = np.random.default_rng(fed.seed + 0x5EED)
            bucket = rng.integers(0, self.r, model_dim)
            sign = rng.choice(np.float32([-1.0, 1.0]), model_dim)
            self._shared = _Tables(sketch_tables(bucket, sign, self.r, device))
            _SHARED[key] = self._shared
        self.tables = self._shared.tables

    @property
    def bucket(self) -> torch.Tensor:
        """(D,) int64 bucket of each coordinate, decoded from the tables."""
        return decode_tables(*self.tables)[0]

    @property
    def sign(self) -> torch.Tensor:
        """(D,) float32 +-1 sign of each coordinate."""
        return decode_tables(*self.tables)[1]

    def history_dim(self, model_dim: int) -> int:
        return self.r

    def sketch(self, rows):
        """(n, D) -> (n, r) signed-bucket count sketch."""
        return count_sketch(rows, *self.tables)

    def update_history(self, history, deltas, active, *,
                       comms: ClientComms = IDENTITY):
        return fg.update_history(history, self.sketch(deltas), active,
                                 decay=self.decay, comms=comms)

    def weights(self, history, active, *, comms: ClientComms = IDENTITY):
        return fg.cluster_weights(
            history, active, comms=comms, impl=self.impl, power=self.power,
            slack=self.slack, sharpness=self.sharpness,
        )


_STRATEGIES = {
    "none": NoDefense,
    "foolsgold": FoolsGoldDefense,
    "foolsgold_sketch": SketchedFoolsGold,
}


def make_defense(fed: FedConfig, model_dim: int, device="cpu") -> DefenseStrategy:
    """Build the strategy ``FedConfig.resolved_defense`` names."""
    if fed.defense is None:
        warnings.warn(
            "FedConfig.defense is unset; resolving the defense strategy from "
            "the legacy FedConfig.foolsgold bool is deprecated; set "
            'defense="none"|"foolsgold"|"foolsgold_sketch" explicitly',
            DeprecationWarning,
            stacklevel=2,
        )
    name = fed.resolved_defense
    if name not in _STRATEGIES:
        raise ValueError(
            f"unknown FedConfig.defense={name!r} (known: {sorted(_STRATEGIES)})"
        )
    cls = _STRATEGIES[name]
    if cls is NoDefense:
        return NoDefense()
    return cls(fed, model_dim, device)
