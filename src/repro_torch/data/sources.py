"""Digit sample sources (numpy, bit-identical to the reference's).

A source exposes ``sample(n, classes, seed=..., flip_frac=...)`` returning
``(x (n, 784) float32 in [0, 1], y (n,) int32)``, the contract of
``synthetic.make_digits``, so the fleet builders are source-agnostic.

``"synthetic"`` and ``"digits"`` are the procedural generator.  The real
MNIST / EMNIST pools (the IDX loader with its offline fallback) are not
ported yet: ``get_source`` raises for them, naming ROADMAP.md Queue 1
item 13.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import make_digits


def exhaust_choice(rng, pool: np.ndarray, n: int) -> np.ndarray:
    """``n`` draws from ``pool``: without replacement while the pool lasts
    (a full permutation when ``n`` exceeds it), with replacement only for
    the overflow, so no pool element is starved by early duplicates."""
    if n <= len(pool):
        return rng.choice(pool, n, replace=False)
    extra = rng.choice(pool, n - len(pool), replace=True)
    return np.concatenate([rng.permutation(pool), extra])


class DigitSource:
    """A deterministic sampler of (x (n, 784), y (n,)) digit batches."""

    name: str = "source"
    num_classes: int = 10
    fallback: bool = False

    def sample(self, n: int, classes=None, *, seed: int = 0,
               flip_frac: float = 0.0):
        raise NotImplementedError


class SyntheticSource(DigitSource):
    """The procedural generator: ``synthetic.make_digits`` with the seed
    shifted by ``seed_offset`` (0 keeps the legacy builders' numerics)."""

    def __init__(self, name: str = "synthetic", *, seed_offset: int = 0,
                 fallback: bool = False):
        self.name, self.seed_offset, self.fallback = name, seed_offset, fallback

    def sample(self, n, classes=None, *, seed=0, flip_frac=0.0):
        return make_digits(
            n, classes, seed=seed + self.seed_offset, flip_frac=flip_frac
        )


def get_source(name: str = "synthetic", *, cache_dir=None,
               split: str = "train") -> DigitSource:
    """Resolve a dataset name to a sample source: ``"synthetic"`` /
    ``"digits"`` -> the procedural generator."""
    if name in ("synthetic", "digits"):
        return SyntheticSource()
    if name in ("mnist", "emnist"):
        raise NotImplementedError(
            f"dataset {name!r} (the IDX loader and its offline fallback) is "
            "not ported yet: ROADMAP.md Queue 1 item 13"
        )
    raise KeyError(
        f"unknown dataset {name!r}; known: synthetic, digits, mnist, emnist"
    )
