"""Kernels 5-7: the uplink codecs of ``core/compress.py``.

  ``pack_codes``   -- offset-encoded QSGD codes (N, D) int32 -> packed
                      uint8; 4 bits is the half-split layout
                      (``byte[j] = code[j] | code[P + j] << 4``,
                      P = ceil(D / 2)), 8 bits a cast.
  ``unpack_codes`` -- its inverse, (N, P) uint8 -> (N, D) int32.
  ``topk_decode``  -- (N, k) value/index pairs -> dense (N, D) float32 by
                      scatter-add (duplicate indices add; k = 0 is zeros).

The CUDA kernels (``csrc/compress.cu``) replace the Pallas TPU kernels of
``repro/kernels/compress.py``; their plain PyTorch versions are
``ref.pack_codes_ref``, ``ref.unpack_codes_ref`` and ``ref.topk_decode_ref``.
As in the reference, 8 bits is a cast on both sides and runs no kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref


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


def topk_decode(vals, idx, dim: int):
    """vals (N, k) float32, idx (N, k) int32 column indices in [0, dim) ->
    dense (N, dim) float32, duplicate indices adding.  On CPU tensors this
    is the plain version; on CUDA tensors it launches the kernel (k = 0
    returns zeros without a launch, as the reference does).  The kernel
    drops an index outside [0, dim); the plain version raises on one."""
    if not vals.is_cuda:
        return ref.topk_decode_ref(vals, idx, dim)
    if vals.dim() != 2:
        raise ValueError(f"vals must be (N, k), got {tuple(vals.shape)}")
    N, k = vals.shape
    dev = vals.device
    ops.require(vals, "vals", torch.float32, (N, k), dev)
    ops.require(idx, "idx", torch.int32, (N, k), dev)
    if dim < 0:
        raise ValueError(f"dim={dim}")
    if k == 0:
        return torch.zeros((N, dim), dtype=torch.float32, device=dev)
    out = torch.empty((N, dim), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    err = ops.library().fedar_topk_decode(
        vals.data_ptr(), idx.data_ptr(), out.data_ptr(), N, k, dim,
        ops.stream_ptr(vals))
    ops.check_launch(err, "topk_decode")
    topk_decode.launches += 1
    return out


pack_codes.launches = 0
unpack_codes.launches = 0
topk_decode.launches = 0
