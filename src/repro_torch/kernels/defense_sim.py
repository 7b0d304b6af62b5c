"""Kernel 3: the defense's similarity block product
``unit_loc @ unit_full.T``, (M, K) x (N, K) -> (M, N) in fp32.

K is the sketch width r = 256 for ``foolsgold_sketch`` and the model
dimension D for dense FoolsGold.  The CUDA kernel (``csrc/defense_sim.cu``)
is a tiled shared-memory product with a deterministic split over K; it
replaces the Pallas TPU kernel
``repro/kernels/defense_sim.py::sketch_similarity``.  Its plain PyTorch
version is ``ref.sketch_similarity_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref

TILE = 16  # output tile edge, as in csrc/defense_sim.cu
MIN_CHUNK = 256  # no K split below this slice width
TARGET_BLOCKS = 264  # about two blocks per SM of an H100 (132 SMs)


def split_chunk(m: int, n: int, k: int) -> int:
    """K slice width for the split product: enough slices that the grid
    holds about ``TARGET_BLOCKS`` blocks, each slice at least ``MIN_CHUNK``
    wide and a multiple of the tile edge."""
    tiles = -(-m // TILE) * -(-n // TILE)
    splits = max(1, TARGET_BLOCKS // tiles)
    chunk = -(-k // splits)
    chunk = -(-chunk // TILE) * TILE
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
        ops.stream_ptr(unit_loc),
    )
    ops.check_launch(err, "sketch_similarity")
    sketch_similarity.launches += 1
    return out


sketch_similarity.launches = 0
