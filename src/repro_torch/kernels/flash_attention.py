"""Kernel 8: causal (optionally sliding-window) softmax attention with an
online softmax, for the LM trunk's prefill.

The CUDA kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``; its plain PyTorch
version is ``ref.flash_attention_ref``.  Unlike the TPU kernel it takes
GQA's kv heads as they are (the kernel reads kv head ``h // (H // K)``)
and any S (the ragged edge is masked).  bfloat16 runs on the tensor cores
(``wgmma`` on tiles that TMA loads) and needs ``hd % 8 == 0`` (TMA's
16-byte strides); float32 runs on the FMA instance of the earlier design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ops, ref

MAX_HEAD_DIM = 128
BF16_HEAD_DIM_STEP = 8
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, S, H, hd); k, v (B, S, K, hd) with H % K == 0 -> (B, S, H, hd)
    in q's dtype: softmax(q k^T hd^-1/2) v over the keys at positions
    0..S-1, masked to k <= q when ``causal`` and to k > q - ``window`` when
    ``window`` > 0.  On CPU tensors this is the plain version; on CUDA
    tensors it launches the kernel, which takes float32 or bfloat16 and
    hd <= 128, in bfloat16 a multiple of 8."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k, v must be (B, S, heads, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, S, H, hd = q.shape
    K = k.shape[2]
    if K < 1 or H % K:
        raise ValueError(f"{H} query heads do not split over {K} kv heads")
    if window < 0:
        raise ValueError(f"window={window}")
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the flash_attention kernel has no backward: an input "
                           "requires grad, and its output would carry none (take "
                           'attn_impl="einsum" for a loss)')
    if q.dtype not in _DTYPES:
        raise ValueError(f"q has dtype {q.dtype}; the kernel takes {list(_DTYPES)}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} is outside the kernel's 1..{MAX_HEAD_DIM}")
    if q.dtype == torch.bfloat16 and hd % BF16_HEAD_DIM_STEP:
        raise ValueError(f"head_dim {hd}: the bfloat16 kernel takes multiples of "
                         f"{BF16_HEAD_DIM_STEP} (TMA strides are multiples of 16 bytes)")
    dev = q.device
    ops.require(q, "q", q.dtype, (B, S, H, hd), dev)
    ops.require(k, "k", q.dtype, (B, S, K, hd), dev)
    ops.require(v, "v", q.dtype, (B, S, K, hd), dev)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bfloat16 kernel reads q, k and v through TMA, which "
                         "needs 16-byte aligned storage")
    err = ops.library().fedar_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, K, hd,
        int(causal), int(window), int(q.dtype == torch.bfloat16), ops.stream_ptr(q))
    ops.check_launch(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def tensor_core_attrs(hdp: int) -> dict:
    """The bfloat16 instance's resources at head-dim padding ``hdp`` (64 or
    128): registers and spilled (local) bytes a thread, static and dynamic
    shared bytes a block, as ``cudaFuncGetAttributes`` reports them."""
    vals = [ctypes.c_int() for _ in range(4)]
    ops.check_launch(ops.library().fedar_flash_attention_attrs(
        hdp, *(ctypes.byref(v) for v in vals)), "flash_attention_attrs")
    return dict(zip(("registers", "local_bytes", "static_smem", "dynamic_smem"),
                    (v.value for v in vals)))
