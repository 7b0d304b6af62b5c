"""Pluggable robust defense (§III.B.6, selected by ``FedConfig.defense``).

A strategy owns a carried per-client history block (its width and its
per-round update, decay included) and a per-round ``weights`` statistic:

  ``none``              -- no carried history (N, 0), no re-weighting.
  ``foolsgold``         -- the paper's dense Fung et al. statistic over the
                           (N, D) cumulative update history.
  ``foolsgold_sketch``  -- cluster-aware variant over a count sketch of the
                           deltas, D -> r (r = ``defense_sketch_dim``).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.common.config import FedConfig
from repro_torch.core import foolsgold as fg


class DefenseStrategy:
    """Interface the engine's round calls, strategy-agnostically.

    ``history_dim``    -- width of the carried per-client history block.
    ``update_history`` -- fold this round's deltas (N, D) into the history.
    ``weights``        -- (N,) aggregation weights in [0, 1], or ``None``
                          when the strategy does not re-weight.
    ``cohort_compatible`` -- whether the per-client history is small enough
                          for the cohort engine's host store.
    """

    name = "none"
    cohort_compatible = True

    def history_dim(self, model_dim: int) -> int:
        return 0

    def update_history(self, history, deltas, active):
        return history

    def weights(self, history, active):
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

    def update_history(self, history, deltas, active):
        return fg.update_history(history, deltas, active, decay=self.decay)

    def weights(self, history, active):
        return fg.foolsgold_weights(history, active, impl=self.impl)


class SketchedFoolsGold(DefenseStrategy):
    """Cluster-aware FoolsGold over a count-sketched (N, r) history.

    Coordinate d adds ``sign[d] * x[d]`` into bucket ``bucket[d]``.  The
    tables come from ``np.random.default_rng(seed + 0x5EED)`` exactly as in
    the reference, so they are bit-identical to its tables.

    The sketch is one fp32 product with the (D, r) matrix ``proj`` that
    holds ``sign[d]`` at (d, ``bucket[d]``) and zeros elsewhere, so each
    output sums in the same order on every run.  A scatter-add
    (``index_add_``) adds in a varying order on the card, which would make
    a resumed run differ from an uninterrupted one."""

    name = "foolsgold_sketch"

    def __init__(self, fed: FedConfig, model_dim: int, device):
        self.r = fed.defense_sketch_dim
        self.decay = fed.defense_history_decay
        self.impl = fed.defense_impl
        self.power = fed.defense_cluster_power
        self.slack = fed.defense_cluster_slack
        self.sharpness = fed.defense_cluster_sharpness
        rng = np.random.default_rng(fed.seed + 0x5EED)
        self.bucket = torch.as_tensor(rng.integers(0, self.r, model_dim),
                                      dtype=torch.int64, device=device)
        self.sign = torch.as_tensor(rng.choice(np.float32([-1.0, 1.0]), model_dim),
                                    device=device)
        self.proj = torch.zeros((model_dim, self.r), device=device)
        self.proj[torch.arange(model_dim, device=device), self.bucket] = self.sign

    def history_dim(self, model_dim: int) -> int:
        return self.r

    def sketch(self, rows):
        """(n, D) -> (n, r) signed-bucket count sketch."""
        return rows @ self.proj

    def update_history(self, history, deltas, active):
        return fg.update_history(history, self.sketch(deltas), active,
                                 decay=self.decay)

    def weights(self, history, active):
        return fg.cluster_weights(
            history, active, impl=self.impl, power=self.power,
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
