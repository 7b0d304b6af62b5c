"""Kernels 5-7: the uplink codecs of ``core/compress.py``.

  ``pack_codes``   -- offset-encoded QSGD codes (N, D) int32 -> packed
                      uint8; 4 bits is the half-split layout
                      (``byte[j] = code[j] | code[P + j] << 4``,
                      P = ceil(D / 2)), 8 bits a cast.
  ``unpack_codes`` -- its inverse, (N, P) uint8 -> (N, D) int32.
  ``topk_decode``  -- (N, k) value/index pairs -> dense (N, D) float32 by
                      scatter-add (duplicate indices add; k = 0 is zeros).
                      One launch: windows of ``TOPK_WINDOW`` floats over
                      the flat output, each scattered in shared memory and
                      written out once by a bulk copy.

The CUDA kernels (``csrc/compress.cu``) replace the Pallas TPU kernels of
``repro/kernels/compress.py``; their plain PyTorch versions are
``ref.pack_codes_ref``, ``ref.unpack_codes_ref`` and ``ref.topk_decode_ref``.
As in the reference, 8 bits is a cast on both sides and runs no kernel.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import ops, ref

# topk_decode's launch, as csrc/compress.cu runs it: the floats a window
# covers (a multiple of 4, so every window starts 16-byte aligned; 8,192 was
# the fastest of 4,096 to 16,384 on the H100, PERF.md), and the window
# buffers (kTopkBuffers) and threads (kTopkThreads) of a block
TOPK_WINDOW = 8192
TOPK_BUFFERS = 2
TOPK_THREADS = 256
_TOPK_SMEM_BYTES = TOPK_BUFFERS * TOPK_WINDOW * 4
# an H100 SM: its count, the shared memory its blocks share (228 KB, of
# which the runtime keeps 1 KB a block) and the threads it holds
H100_SMS = 132
_SM_SMEM_BYTES = 233472
_BLOCK_RESERVED_SMEM = 1024
_SM_THREADS = 2048
# the decode's blocks an SM holds at its shared bytes and threads
_TOPK_BLOCKS_PER_SM = min(_SM_SMEM_BYTES // (_TOPK_SMEM_BYTES + _BLOCK_RESERVED_SMEM),
                          _SM_THREADS // TOPK_THREADS)


def _check_bits(bits: int) -> None:
    if bits not in (4, 8):
        raise ValueError(f"bits={bits!r}: the codecs pack 4 or 8 bits per code")


def pack_codes(codes, *, bits: int):
    """codes (N, D) int32 in [0, 2^bits) -> (N, ceil(D * bits / 8)) uint8.
    On CPU tensors, and at 8 bits, this is the plain version; on CUDA
    tensors at 4 bits it launches the kernel."""
    _check_bits(bits)
    if not codes.is_cuda or bits == 8:
        return ref.pack_codes_ref(codes, bits=bits)
    if codes.dim() != 2:
        raise ValueError(f"codes must be (N, D), got {tuple(codes.shape)}")
    N, D = codes.shape
    ops.require(codes, "codes", torch.int32, (N, D), codes.device)
    out = torch.empty((N, (D + 1) // 2), dtype=torch.uint8, device=codes.device)
    if out.numel() == 0:
        return out
    err = ops.library().fedar_pack_codes4(
        codes.data_ptr(), out.data_ptr(), N, D, ops.stream_ptr(codes))
    ops.check_launch(err, "pack_codes")
    pack_codes.launches += 1
    return out


def unpack_codes(packed, *, bits: int, dim: int):
    """packed (N, P) uint8 -> (N, dim) int32 codes.  On CPU tensors, and at
    8 bits, this is the plain version; on CUDA tensors at 4 bits it
    launches the kernel (which needs dim <= 2P)."""
    _check_bits(bits)
    if not packed.is_cuda or bits == 8:
        return ref.unpack_codes_ref(packed, bits=bits, dim=dim)
    if packed.dim() != 2:
        raise ValueError(f"packed must be (N, P), got {tuple(packed.shape)}")
    N, P = packed.shape
    ops.require(packed, "packed", torch.uint8, (N, P), packed.device)
    if not 0 <= dim <= 2 * P:
        raise ValueError(f"dim={dim} does not fit {P} packed bytes per row")
    out = torch.empty((N, dim), dtype=torch.int32, device=packed.device)
    if out.numel() == 0:
        return out
    err = ops.library().fedar_unpack_codes4(
        packed.data_ptr(), out.data_ptr(), N, P, dim, ops.stream_ptr(packed))
    ops.check_launch(err, "unpack_codes")
    unpack_codes.launches += 1
    return out


def _topk_grid(N: int, D: int, sms: int) -> tuple[int, int]:
    """(windows, blocks): the windows of ``TOPK_WINDOW`` floats over the
    flat N * D output, and the persistent grid that walks them (the SMs
    times the blocks an SM holds, at most one a window)."""
    windows = -(-N * D // TOPK_WINDOW)
    return windows, min(windows, sms * _TOPK_BLOCKS_PER_SM)


def topk_plan(N: int, k: int, D: int, *, sms: int = H100_SMS) -> dict:
    """``topk_decode``'s launch for (N, k) pairs into (N, D): window ``w``
    covers the flat output ``[w * window, min((w + 1) * window, N * D))``,
    so a window may start mid-row and span several rows; a persistent grid
    of ``blocks`` walks them, each block with ``buffers`` windows of shared
    memory (``smem_bytes``) and ``threads`` threads.  ``rows_per_window_max``,
    the most rows a window spans, is counted here for the checks: the
    kernel finds a window's rows from its bounds."""
    windows, blocks = _topk_grid(N, D, sms)
    rows_max = 0
    if windows:
        starts = np.arange(windows, dtype=np.int64) * TOPK_WINDOW
        last = np.minimum(starts + TOPK_WINDOW, N * D) - 1
        rows_max = int((last // D - starts // D + 1).max())
    return dict(window=TOPK_WINDOW, windows=windows, blocks=blocks, buffers=TOPK_BUFFERS,
                threads=TOPK_THREADS, smem_bytes=_TOPK_SMEM_BYTES,
                rows_per_window_max=rows_max)


def topk_decode_attrs(smem_bytes: int) -> dict:
    """The decode kernel's registers a thread and the blocks an SM holds at
    ``smem_bytes``, as ``cudaFuncGetAttributes`` and the occupancy API
    report them (needs the card)."""
    per_sm, regs = ctypes.c_int(), ctypes.c_int()
    ops.check_launch(ops.library().fedar_topk_decode_attrs(
        smem_bytes, ctypes.byref(per_sm), ctypes.byref(regs)), "topk_decode_attrs")
    return dict(registers=regs.value, blocks_per_sm=per_sm.value)


def topk_decode(vals, idx, dim: int):
    """vals (N, k) float32, idx (N, k) int32 column indices in [0, dim) ->
    dense (N, dim) float32, duplicate indices adding.  On CPU tensors this
    is the plain version; on CUDA tensors it launches the kernel once,
    tiled as ``topk_plan(N, k, dim)`` says (k = 0 returns zeros without a
    launch, as the reference does).  The kernel drops an index outside
    [0, dim); the plain version raises on one."""
    if not vals.is_cuda:
        return ref.topk_decode_ref(vals, idx, dim)
    if vals.dim() != 2:
        raise ValueError(f"vals must be (N, k), got {tuple(vals.shape)}")
    N, k = vals.shape
    dev = vals.device
    ops.require(vals, "vals", torch.float32, (N, k), dev)
    ops.require(idx, "idx", torch.int32, (N, k), dev)
    if not 0 <= dim < 2 ** 31:
        raise ValueError(f"dim={dim}: the kernel's columns are int32 indices")
    if k == 0:
        return torch.zeros((N, dim), dtype=torch.float32, device=dev)
    out = torch.empty((N, dim), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if out.data_ptr() % 16:
        # never from torch.empty (its blocks are 512-byte aligned); the bulk
        # copies write 16-byte units from the output's first byte
        raise ValueError("topk_decode: the output must be 16-byte aligned")
    _, blocks = _topk_grid(N, dim, _sms(dev))
    err = ops.library().fedar_topk_decode(
        vals.data_ptr(), idx.data_ptr(), out.data_ptr(), N, k, dim, TOPK_WINDOW,
        blocks, _TOPK_SMEM_BYTES, ops.stream_ptr(vals))
    ops.check_launch(err, "topk_decode")
    topk_decode.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


pack_codes.launches = 0
unpack_codes.launches = 0
topk_decode.launches = 0
