"""Synthetic digits: a procedurally generated 28x28 10-class dataset standing
in for the paper's MNIST/EMNIST + robot-captured digit mix.  Plain numpy, so
the arrays are bit-identical to the reference package's for the same seed."""
from __future__ import annotations

import numpy as np


def digit_prototypes(seed: int = 1234) -> np.ndarray:
    """(10, 28, 28) smooth class prototypes built from random stroke fields."""
    rng = np.random.default_rng(seed)
    protos = []
    yy, xx = np.mgrid[0:28, 0:28] / 27.0
    for _c in range(10):
        acc = np.zeros((28, 28))
        for _ in range(3):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            sx, sy = rng.uniform(0.05, 0.25, 2)
            th = rng.uniform(0, np.pi)
            xr = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
            yr = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
            acc += np.exp(-(xr**2 / (2 * sx**2) + yr**2 / (2 * sy**2)))
        acc /= acc.max()
        protos.append(acc)
    return np.stack(protos)


def flip_labels(rng, y, flip_frac: float, num_classes: int = 10):
    """Poison ``flip_frac`` of ``y`` in place with random relabels.  Consumes
    ``rng.choice`` then ``rng.integers``: seed-exact streams depend on that
    order."""
    k = int(len(y) * flip_frac)
    idx = rng.choice(len(y), k, replace=False)
    y[idx] = (y[idx] + rng.integers(1, num_classes, k)) % num_classes
    return y


def make_digits(
    n: int, classes=None, *, seed: int = 0, noise: float = 0.35, flip_frac: float = 0.0
):
    """Returns (x (n, 784) float32 in [0,1], y (n,) int32); ``flip_frac`` > 0
    poisons that fraction of labels."""
    rng = np.random.default_rng(seed)
    protos = digit_prototypes()
    classes = np.asarray(classes if classes is not None else np.arange(10))
    y = rng.choice(classes, n)
    x = protos[y] + noise * rng.standard_normal((n, 28, 28))
    x += rng.uniform(-0.1, 0.1, (n, 1, 1))
    x = np.clip(x, 0, 1).reshape(n, 784).astype(np.float32)
    if flip_frac > 0:
        flip_labels(rng, y, flip_frac)
    return x, y.astype(np.int32)
