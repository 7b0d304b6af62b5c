"""Kernel 8: causal (optionally sliding-window) softmax attention with an
online softmax, for the LM trunk's prefill.

The CUDA kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``; its plain PyTorch
version is ``ref.flash_attention_ref``.  Unlike the TPU kernel it takes
GQA's kv heads as they are (the kernel reads kv head ``h // (H // K)``)
and any S (the ragged edge is masked).  Both instances take hd up to 256,
as the TPU kernel does for every config of the repo; a larger hd raises.

bfloat16 runs on the tensor cores (``wgmma`` on tiles that TMA loads) and
needs ``hd % 8 == 0`` (TMA's 16-byte strides); it pads hd to 64, 128 or 256
(64-key tiles at 256, to fit shared memory).

float32 runs on the CUDA cores, with register tiles fed by 16-byte shared
reads and K and V copied by ``cp.async`` while the FMAs run; any hd from 1
to 256 (16-byte copies where hd % 4 == 0, 4-byte ones otherwise).
``fp32_plan`` picks its instance and tiles from the shapes (256 query rows
against 64-key tiles at hd <= 64, 128 against 128 at hd <= 128, 64 against
64 above) and, where the grid would leave SMs idle, a split of each query
tile's live key tiles into parts whose partial rows a second kernel merges
in a fixed order.  ``fp32_attrs`` reports the
instances' registers, spills and shared bytes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import ops, ref

MAX_HEAD_DIM = 256
BF16_HEAD_DIM_STEP = 8
_DTYPES = (torch.float32, torch.bfloat16)

# the fp32 instances (csrc/flash_attention.cu's Fp32Tile), by the largest
# hd each takes: query rows and keys a tile, lanes that share a row group.
# 256 threads a block; P passes through shared memory 32 keys at a time, in
# rows of 32 + lanes floats, beside each row's running max and sum.  At
# most 16 parts, and the grid's y axis (query tiles x parts) within CUDA's
# 65,535.
FP32_INSTANCES = {64: (256, 64, 8), 128: (128, 128, 16), 256: (64, 64, 16)}
FP32_THREADS = 256
FP32_P_CHUNK = 32
FP32_MAX_PARTS = 16
MAX_GRID_Y = 65535
H100_SMS = 132


class Fp32Plan(NamedTuple):
    """The fp32 kernel's plan for one shape: the instance (the largest hd
    it takes, 128 or 256), query and key rows a tile, threads a block, the
    floats of a shared row of Q, K and V (``pitch``), dynamic shared bytes a
    block, the bytes of one ``cp.async`` copy (16 where hd % 4 == 0, else
    4), the parts each query tile's live key tiles are split into, the
    attention kernel's blocks, and the floats of the split's workspace (0
    without a split)."""
    instance: int
    block_q: int
    block_k: int
    threads: int
    pitch: int
    smem_bytes: int
    copy_bytes: int
    parts: int
    blocks: int
    workspace: int


def fp32_pitch(hd: int) -> int:
    """hd rounded up to 4 and then to an odd number of float4s (so that 8
    consecutive shared rows start in 8 distinct 16-byte bank groups)."""
    return 4 * ((-(-hd // 4)) | 1)


def fp32_key_tiles(S: int, block_q: int, block_k: int, qt: int, *, causal: bool,
                   window: int) -> tuple:
    """The live key tiles [first, end) of query tile ``qt``: up to the
    diagonal when causal, from the tile holding the window's first key of
    the tile's first row when windowed."""
    q0 = qt * block_q
    k_end = min(S, q0 + block_q) if causal else S
    first = max(0, q0 - window + 1) // block_k if window > 0 else 0
    return first, -(-k_end // block_k)


def fp32_part_tiles(first: int, end: int, part: int, parts: int) -> tuple:
    """Part ``part`` of ``parts`` of the key tiles [first, end): contiguous,
    as even as integer division makes them (empty where there are fewer
    tiles than parts)."""
    n = end - first
    return first + part * n // parts, first + (part + 1) * n // parts


def fp32_plan(B: int, S: int, H: int, K: int, hd: int, window: int = 0, *,
              causal: bool = True, sms: int = H100_SMS, parts: int | None = None) -> Fp32Plan:
    """The fp32 kernel's plan for q (B, S, H, hd) against k, v (B, S, K,
    hd), chosen from the shapes and the card's SM count alone.  One block
    runs on an SM at a time.  Where B H ceil(S / block_q) blocks would leave
    SMs idle, each query tile's live key tiles are split into the fewest
    parts that give two blocks an SM (no more parts than the longest tile
    has key tiles, at most 16).  ``parts`` forces a split (1 for none; the
    tests and ``chip_smoke.py`` hold both against the plain version).
    Raises ``ValueError`` for a shape no plan takes."""
    if parts is not None and not 1 <= parts <= FP32_MAX_PARTS:
        raise ValueError(f"parts={parts} is outside 1..{FP32_MAX_PARTS}")
    if min(B, S, H, K, sms) < 1 or H % K or window < 0:
        raise ValueError(f"fp32 attention takes no plan at B={B}, S={S}, H={H}, K={K}, "
                         f"window={window}, {sms} SMs")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} is outside the fp32 kernel's 1..{MAX_HEAD_DIM}")
    instance = next(i for i in sorted(FP32_INSTANCES) if hd <= i)
    block_q, block_k, lanes = FP32_INSTANCES[instance]
    nq = -(-S // block_q)
    pitch = fp32_pitch(hd)
    smem = 4 * ((block_q + 2 * block_k) * pitch + block_q * (FP32_P_CHUNK + lanes + 2))
    blocks = B * H * nq
    if parts is None and blocks >= sms:
        parts = 1
    elif parts is None:
        longest = max(e - f for f, e in (fp32_key_tiles(S, block_q, block_k, qt, causal=causal,
                                                        window=window) for qt in range(nq)))
        parts = max(1, min(longest, FP32_MAX_PARTS, -(-2 * sms // blocks)))
    if nq * parts > MAX_GRID_Y:
        raise ValueError(f"S={S} makes {nq} query tiles of {parts} parts, past the grid's "
                         f"{MAX_GRID_Y}")
    workspace = blocks * parts * block_q * (hd + 2) if parts > 1 else 0
    return Fp32Plan(instance, block_q, block_k, FP32_THREADS, pitch, smem,
                    16 if hd % 4 == 0 else 4, parts, blocks * parts, workspace)


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    parts: int | None = None):
    """q (B, S, H, hd); k, v (B, S, K, hd) with H % K == 0 -> (B, S, H, hd)
    in q's dtype: softmax(q k^T hd^-1/2) v over the keys at positions
    0..S-1, masked to k <= q when ``causal`` and to k > q - ``window`` when
    ``window`` > 0.  On CPU tensors this is the plain version; on CUDA
    tensors it launches the kernel, which takes float32 or bfloat16 and
    hd <= 256, in bfloat16 a multiple of 8.  ``parts`` forces the fp32
    plan's key split (``fp32_plan``)."""
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
    lib = ops.library()
    if q.dtype == torch.bfloat16:
        if parts is not None:
            raise ValueError("parts splits the float32 kernel's keys; the bfloat16 one "
                             "takes none")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("the bfloat16 kernel reads q, k and v through TMA, which "
                             "needs 16-byte aligned storage")
        err = lib.fedar_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, K, hd,
            int(causal), int(window), ops.stream_ptr(q))
    else:
        p = fp32_plan(B, S, H, K, hd, window, causal=causal, sms=_sms(dev.index or 0),
                      parts=parts)
        ws = None
        part_o = part_ml = None
        if p.parts > 1:
            ws = torch.empty(p.workspace, dtype=torch.float32, device=dev)
            n_o = p.blocks * p.block_q * hd
            part_o, part_ml = ws.data_ptr(), ws[n_o:].data_ptr()
        vec = p.copy_bytes == 16 and not any(
            t.data_ptr() % 16 for t in (q, k, v, out) + ((ws,) if ws is not None else ()))
        err = lib.fedar_flash_attention_fp32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part_o, part_ml,
            B, S, H, K, hd, int(causal), int(window), p.block_q, p.parts, int(vec),
            ops.stream_ptr(q))
    ops.check_launch(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def tensor_core_attrs(hdp: int) -> dict:
    """The bfloat16 instance's resources at head-dim padding ``hdp`` (64,
    128 or 256): registers and spilled (local) bytes a thread, static and dynamic
    shared bytes a block, as ``cudaFuncGetAttributes`` reports them."""
    vals = [ctypes.c_int() for _ in range(4)]
    ops.check_launch(ops.library().fedar_flash_attention_attrs(
        hdp, *(ctypes.byref(v) for v in vals)), "flash_attention_attrs")
    return dict(zip(("registers", "local_bytes", "static_smem", "dynamic_smem"),
                    (v.value for v in vals)))


FP32_KERNELS = tuple(f"{i}, {b}-byte copies" for i in FP32_INSTANCES for b in (16, 4)) + (
    "merge",)


def fp32_attrs(hd: int = 0) -> dict:
    """The fp32 kernels' resources (``FP32_KERNELS``: each instance with
    each copy width, and the merge kernel): registers and spilled (local)
    bytes a thread and static shared bytes a block, as
    ``cudaFuncGetAttributes`` reports them, and the dynamic shared bytes a
    block of the instance takes at head dim ``hd`` (0 for the merge, or
    where ``hd`` is 0 or past the instance)."""
    out = {}
    for which, name in enumerate(FP32_KERNELS):
        vals = [ctypes.c_int() for _ in range(4)]
        ops.check_launch(ops.library().fedar_flash_attention_fp32_attrs(
            which, hd, *(ctypes.byref(v) for v in vals)), "flash_attention_fp32_attrs")
        out[name] = dict(zip(("registers", "local_bytes", "static_smem", "dynamic_smem"),
                             (v.value for v in vals)))
    return out
