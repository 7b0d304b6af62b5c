"""Kernel 3: the defense's similarity block product
``unit_loc @ unit_full.T``, (M, K) x (N, K) -> (M, N) in fp32.

K is the sketch width r = 256 for ``foolsgold_sketch`` and the model
dimension D for dense FoolsGold.  The CUDA kernel (``csrc/defense_sim.cu``)
computes 32 x 64 output tiles (16 x 16 for small outputs) from fp32
register tiles, with K slices staged by ``cp.async`` and a deterministic
split over K; it replaces the Pallas TPU kernel
``repro/kernels/defense_sim.py::sketch_similarity``.  Its plain PyTorch
version is ``ref.sketch_similarity_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref

LARGE_TILE = (32, 64)  # a block's output tile, as in csrc/defense_sim.cu
SMALL_TILE = (16, 16)  # ... for outputs that fill under half the card
TILE_K = 32  # K slice of one pipeline stage; a split is whole slices
MIN_CHUNK = 256  # no K split below this slice width
TARGET_BLOCKS = 264  # about two blocks per SM of an H100 (132 SMs)
SMS = 132


def _tiles(m: int, n: int, tile) -> int:
    return -(-m // tile[0]) * -(-n // tile[1])


def small_tiles(m: int, n: int) -> bool:
    """Whether an (m, n) output takes the small tile: its large tiles
    would occupy under half the SMs."""
    return _tiles(m, n, LARGE_TILE) < SMS // 2


def split_chunk(m: int, n: int, k: int) -> int:
    """K slice width for the split product: enough slices that the grid
    holds about ``TARGET_BLOCKS`` blocks, each slice at least ``MIN_CHUNK``
    wide and a multiple of ``TILE_K``."""
    tiles = _tiles(m, n, SMALL_TILE if small_tiles(m, n) else LARGE_TILE)
    splits = max(1, TARGET_BLOCKS // tiles)
    chunk = -(-k // splits)
    chunk = -(-chunk // TILE_K) * TILE_K
    return max(MIN_CHUNK, chunk)


def sketch_similarity(unit_loc, unit_full):
    """unit_loc (M, K) float32, unit_full (N, K) float32 -> (M, N) float32
    ``unit_loc @ unit_full.T``.  On CPU tensors this is the plain version;
    on CUDA tensors it launches the kernel."""
    if not unit_loc.is_cuda:
        return ref.sketch_similarity_ref(unit_loc, unit_full)
    dev = unit_loc.device
    if unit_loc.dim() != 2 or unit_full.dim() != 2:
        raise ValueError("sketch_similarity takes two 2-D operands")
    M, K = unit_loc.shape
    N = unit_full.shape[0]
    if K == 0:
        raise ValueError("sketch_similarity needs K > 0")
    ops.require(unit_loc, "unit_loc", torch.float32, (M, K), dev)
    ops.require(unit_full, "unit_full", torch.float32, (N, K), dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    chunk = split_chunk(M, N, K)
    splits = -(-K // chunk)
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    lib = ops.library()
    err = lib.fedar_sketch_similarity(
        unit_loc.data_ptr(), unit_full.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), M, N, K, chunk,
        int(small_tiles(M, N)), ops.stream_ptr(unit_loc),
    )
    ops.check_launch(err, "sketch_similarity")
    sketch_similarity.launches += 1
    return out


sketch_similarity.launches = 0
