"""Digit sample sources (numpy, bit-identical to the reference's): real
MNIST / EMNIST from local IDX files, and the deterministic offline fallback.

The offline contract:

  * ``get_source("mnist" | "emnist", cache_dir=...)`` looks for the standard
    IDX files (optionally gzipped) under a local cache dir (the
    ``cache_dir`` argument, else ``$FEDAR_DATA_DIR``, else
    ``~/.cache/fedar``), at the top level and under a ``<name>/``
    subdirectory.  Nothing is ever downloaded.
  * When the files are absent the loader returns a ``SyntheticSource``
    tagged ``fallback=True`` whose samples come from the procedural
    generator (``data/synthetic.py``) with a per-dataset seed offset, so a
    run with no cache goes through the same pipeline, reproducibly.

A source exposes ``sample(n, classes, seed=..., flip_frac=...)`` returning
``(x (n, 784) float32 in [0, 1], y (n,) int32)``, the contract of
``synthetic.make_digits``, so the fleet builders are source-agnostic.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

from repro_torch.data.synthetic import flip_labels, make_digits

# IDX dtype codes (the MNIST file format)
IDX_DTYPES = {
    0x08: np.uint8,
    0x09: np.int8,
    0x0B: np.int16,
    0x0C: np.int32,
    0x0D: np.float32,
    0x0E: np.float64,
}

# (dataset, split) -> (images file, labels file); EMNIST uses the "digits"
# split so the paper's 10-class MLP applies unchanged
IDX_FILES = {
    ("mnist", "train"): ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    ("mnist", "test"): ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    ("emnist", "train"): (
        "emnist-digits-train-images-idx3-ubyte",
        "emnist-digits-train-labels-idx1-ubyte",
    ),
    ("emnist", "test"): (
        "emnist-digits-test-images-idx3-ubyte",
        "emnist-digits-test-labels-idx1-ubyte",
    ),
}

# seed offsets that keep the mnist and emnist fallbacks distinct (and each
# reproducible) synthetic pools
_FALLBACK_OFFSETS = {"mnist": 1013, "emnist": 2027}


def exhaust_choice(rng, pool: np.ndarray, n: int) -> np.ndarray:
    """``n`` draws from ``pool``: without replacement while the pool lasts
    (a full permutation when ``n`` exceeds it), with replacement only for
    the overflow, so no pool element is starved by early duplicates."""
    if n <= len(pool):
        return rng.choice(pool, n, replace=False)
    extra = rng.choice(pool, n - len(pool), replace=True)
    return np.concatenate([rng.permutation(pool), extra])


def default_cache_dir() -> str:
    return os.environ.get("FEDAR_DATA_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "fedar"
    )


def parse_idx(raw: bytes) -> np.ndarray:
    """Parse one IDX payload (images or labels) into an ndarray."""
    if len(raw) < 4:
        raise ValueError("IDX payload truncated before magic")
    zeros, dtype_code, ndim = struct.unpack(">HBB", raw[:4])
    if zeros != 0:
        raise ValueError(f"bad IDX magic: leading bytes {zeros:#06x} != 0")
    if dtype_code not in IDX_DTYPES:
        raise ValueError(f"unknown IDX dtype code {dtype_code:#04x}")
    dtype = np.dtype(IDX_DTYPES[dtype_code]).newbyteorder(">")
    header_end = 4 + 4 * ndim
    dims = struct.unpack(f">{ndim}I", raw[4:header_end])
    expect = int(np.prod(dims)) * dtype.itemsize
    body = raw[header_end: header_end + expect]
    if len(body) != expect:
        raise ValueError(
            f"IDX body holds {len(body)} bytes, dims {dims} need {expect}"
        )
    return np.frombuffer(body, dtype=dtype).reshape(dims)


def read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return parse_idx(f.read())


def _find(cache_dir: str, name: str, fname: str) -> Optional[str]:
    for base in (cache_dir, os.path.join(cache_dir, name)):
        for suffix in ("", ".gz"):
            p = os.path.join(base, fname + suffix)
            if os.path.isfile(p):
                return p
    return None


def load_idx_split(name: str, split: str = "train",
                   cache_dir: Optional[str] = None):
    """(x (n, 784) float32 in [0, 1], y (n,) int32) from cached IDX files,
    or ``None`` when the cache does not hold this dataset / split (the
    caller falls back to the synthetic source, never to the network)."""
    if (name, split) not in IDX_FILES:
        raise KeyError(f"unknown IDX dataset/split {(name, split)!r}")
    cache_dir = cache_dir or default_cache_dir()
    img_name, lab_name = IDX_FILES[(name, split)]
    img_path = _find(cache_dir, name, img_name)
    lab_path = _find(cache_dir, name, lab_name)
    if img_path is None or lab_path is None:
        return None
    x, y = read_idx(img_path), read_idx(lab_path)
    if x.ndim != 3 or y.ndim != 1 or x.shape[0] != y.shape[0]:
        raise ValueError(
            f"IDX shape mismatch for {name}/{split}: {x.shape} vs {y.shape}"
        )
    if name == "emnist":
        # EMNIST stores its images transposed against MNIST's
        x = x.transpose(0, 2, 1)
    x = (x.reshape(x.shape[0], -1).astype(np.float32)) / 255.0
    return x, y.astype(np.int32)


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


class ArraySource(DigitSource):
    """A real dataset held as arrays (MNIST / EMNIST loaded from IDX).
    Sampling is without replacement while the (class-filtered) pool lasts
    and with replacement beyond it (``exhaust_choice``), so a fleet can draw
    more samples than the pool holds."""

    def __init__(self, name: str, x: np.ndarray, y: np.ndarray):
        self.name, self.x, self.y = name, x, y
        self.num_classes = int(y.max()) + 1 if len(y) else 10

    def __len__(self):
        return len(self.y)

    def sample(self, n, classes=None, *, seed=0, flip_frac=0.0):
        rng = np.random.default_rng(seed)
        if classes is not None:
            pool = np.where(np.isin(self.y, np.asarray(classes)))[0]
        else:
            pool = np.arange(len(self.y))
        if len(pool) == 0:
            raise ValueError(f"{self.name}: no samples for classes {classes}")
        idx = exhaust_choice(rng, pool, n)
        x, y = self.x[idx], self.y[idx].astype(np.int64)
        if flip_frac > 0:
            flip_labels(rng, y, flip_frac, self.num_classes)
        return x, y.astype(np.int32)


def get_source(name: str = "synthetic", *, cache_dir: Optional[str] = None,
               split: str = "train") -> DigitSource:
    """Resolve a dataset name to a sample source: ``"synthetic"`` /
    ``"digits"`` -> the procedural generator; ``"mnist"`` / ``"emnist"`` ->
    an ``ArraySource`` over cached IDX files, or the deterministic synthetic
    fallback (``.fallback == True``) when the cache is cold."""
    if name in ("synthetic", "digits"):
        return SyntheticSource()
    if name in ("mnist", "emnist"):
        loaded = load_idx_split(name, split, cache_dir)
        if loaded is not None:
            return ArraySource(name, *loaded)
        return SyntheticSource(
            name=f"{name}-fallback",
            seed_offset=_FALLBACK_OFFSETS[name],
            fallback=True,
        )
    raise KeyError(
        f"unknown dataset {name!r}; known: synthetic, digits, mnist, emnist"
    )


def eval_source(name: str, train_fallback: bool,
                cache_dir: Optional[str] = None):
    """The test-split source for ``name``, plus a warning string (or
    ``None``) when its fallback status disagrees with the train split's:
    a real pool mixed with the synthetic fallback makes the reported
    accuracy meaningless."""
    src = get_source(name, split="test", cache_dir=cache_dir)
    warn = None
    if name in ("mnist", "emnist") and src.fallback != train_fallback:
        warn = (f"[data] WARNING: {name} train and test splits disagree "
                f"(train {'fallback' if train_fallback else 'real IDX'}, "
                f"test {'fallback' if src.fallback else 'real IDX'}) — "
                "stage both splits in the cache; reported accuracy mixes "
                "sources and is not meaningful")
    return src, warn
