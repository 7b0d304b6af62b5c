"""IDX files (the MNIST format) written into a temp dir for the port's
tests: no real MNIST or EMNIST file is needed or fetched.  Imports no JAX,
so that the card's tests can use it too."""
import gzip
import struct

import numpy as np

from repro_torch.data.sources import IDX_FILES

DTYPE_CODES = {np.uint8: 0x08, np.int8: 0x09, np.int16: 0x0B,
               np.int32: 0x0C, np.float32: 0x0D, np.float64: 0x0E}


def idx_bytes(arr: np.ndarray, code=None) -> bytes:
    code = DTYPE_CODES[arr.dtype.type] if code is None else code
    head = struct.pack(">HBB", 0, code, arr.ndim)
    head += struct.pack(f">{arr.ndim}I", *arr.shape)
    return head + np.ascontiguousarray(arr, arr.dtype.newbyteorder(">")).tobytes()


def digits_idx(n: int, seed: int):
    """(n, 28, 28) uint8 images and (n,) uint8 labels 0-9, every class
    present."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = ((np.arange(n) + seed) % 10).astype(np.uint8)
    return imgs, labels


def write_split(root, name, split, imgs, labels, *, gz=False, subdir=False):
    base = root / name if subdir else root
    base.mkdir(parents=True, exist_ok=True)
    for fname, arr in zip(IDX_FILES[(name, split)], (imgs, labels)):
        raw = idx_bytes(arr)
        if gz:
            (base / (fname + ".gz")).write_bytes(gzip.compress(raw, 1))
        else:
            (base / fname).write_bytes(raw)


def write_cache(root, *, n=120, gz=False, subdir=False, names=("mnist", "emnist"),
                splits=("train", "test")):
    """Both datasets' splits under ``root``; EMNIST's images stored
    transposed, as EMNIST stores them.  Returns {(name, split): (imgs,
    labels)} in MNIST orientation."""
    out = {}
    for k, name in enumerate(names):
        for j, split in enumerate(splits):
            imgs, labels = digits_idx(n // (1 + j), seed=10 * k + j)
            stored = imgs.transpose(0, 2, 1) if name == "emnist" else imgs
            write_split(root, name, split, stored, labels, gz=gz, subdir=subdir)
            out[(name, split)] = (imgs, labels)
    return out
