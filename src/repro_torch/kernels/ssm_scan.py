"""Kernel 9: Mamba2's chunked state-space dual (SSD) scan, for the LM
trunk's prefill.

The CUDA kernel (``csrc/ssm_scan.cu``) replaces the Pallas TPU kernel
``repro/kernels/ssm_scan.py::ssm_scan``; its plain PyTorch version is
``ref.ssm_scan_ref``, the sequential recurrence.  Both instances chunk by
64 positions (the reference's kernel by ``cfg.ssm_chunk``), which changes
the result only by rounding order, and take any S.

bfloat16 runs on the tensor cores (``mma.sync`` bf16 -> fp32 with the
carried state in fp32, fed by a two-stage ``cp.async`` ring), one block
per (batch, head, slice of 32 columns of hd); it takes hd and st
multiples of 8 up to 64 (16-byte rows for the copies) and 16-byte aligned
storage, and raises ``ValueError`` on anything else.  float32 runs on the
FMA instance of the earlier design, one block per (batch, head), any hd,
st <= 64.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ops, ref

MAX_DIM = 64  # largest head_dim and state both instances take
CHUNK = 64  # positions per chunk, both instances
BF16_DIM_STEP = 8  # the bf16 instance's hd and st: multiples of 8 (16 bytes)
COLS = 32  # columns of hd a bf16 block owns
THREADS = 128  # a bf16 block
_STAGES = 2
_DTYPES = (torch.float32, torch.bfloat16)


# Dynamic shared bytes of a bf16 block, as TcSmem::kBytes in the source
# counts them: two stages of (the x slice in rows of COLS * 2 + 16 bytes, B
# and C in rows of 128 bytes, the raw log-decays), the state's bf16 hi and
# lo halves, the cumsum and the weights by chunk parity, one mbarrier a stage.
_X_PITCH = COLS * 2 + 16
SMEM_BYTES = (_STAGES * (CHUNK * _X_PITCH + 2 * CHUNK * 128 + CHUNK * 4)
              + 2 * MAX_DIM * _X_PITCH + 4 * CHUNK * 4 + _STAGES * 8)


def plan(B: int, S: int, nh: int, hd: int, st: int) -> dict:
    """The bf16 instance's launch for (B, S, nh, hd, st): the chunk, the
    columns a block owns, the slices of hd, the blocks and their shared
    bytes.  The state's columns are independent, so zamba2-7b's heads of
    64 run as two blocks each, each recomputing its chunk's C B^T, which
    is cheap beside the bytes.  Raises ``ValueError`` on a shape the
    instance does not take."""
    if not (1 <= hd <= MAX_DIM and 1 <= st <= MAX_DIM):
        raise ValueError(f"head_dim {hd} and state {st} must be in 1..{MAX_DIM}")
    if hd % BF16_DIM_STEP or st % BF16_DIM_STEP:
        raise ValueError(f"head_dim {hd} and state {st}: the bfloat16 kernel takes "
                         f"multiples of {BF16_DIM_STEP} (its copies move 16-byte rows)")
    slices = -(-hd // COLS)
    return dict(chunk=CHUNK, chunks=-(-S // CHUNK), cols=COLS, slices=slices,
                blocks=B * nh * slices, threads=THREADS, smem_bytes=SMEM_BYTES)


def ssm_scan(xd, logdecay, Bc, Cc):
    """xd (B, S, nh, hd) dt-scaled inputs; logdecay (B, S, nh) float32;
    Bc, Cc (B, S, st) in xd's dtype.  Returns y (B, S, nh, hd) in xd's
    dtype, with ``state_t = exp(logdecay_t) state_{t-1} + B_t (x) x_t`` and
    ``y_t = C_t . state_t`` from a zero state.  On CPU tensors this is the
    plain version; on CUDA tensors it launches the kernel, which takes
    float32 or bfloat16 and hd, st <= 64, in bfloat16 multiples of 8."""
    if xd.dim() != 4 or Bc.dim() != 3:
        raise ValueError(f"xd must be (B, S, nh, hd) and Bc (B, S, st), got "
                         f"{tuple(xd.shape)}, {tuple(Bc.shape)}")
    if not xd.is_cuda:
        return ref.ssm_scan_ref(xd, logdecay, Bc, Cc).to(xd.dtype)
    if any(t.requires_grad for t in (xd, logdecay, Bc, Cc)):
        raise RuntimeError("the ssm_scan kernel has no backward: an input requires "
                           'grad, and its output would carry none (take ssm_impl='
                           '"einsum" for a loss)')
    B, S, nh, hd = xd.shape
    st = Bc.shape[-1]
    if xd.dtype not in _DTYPES:
        raise ValueError(f"xd has dtype {xd.dtype}; the kernel takes {list(_DTYPES)}")
    if not (1 <= hd <= MAX_DIM and 1 <= st <= MAX_DIM):
        raise ValueError(f"head_dim {hd} and state {st} must be in 1..{MAX_DIM}")
    bf16 = xd.dtype == torch.bfloat16
    if bf16:
        plan(B, S, nh, hd, st)  # raises on a shape the instance refuses
    dev = xd.device
    ops.require(xd, "xd", xd.dtype, (B, S, nh, hd), dev)
    ops.require(logdecay, "logdecay", torch.float32, (B, S, nh), dev)
    ops.require(Bc, "Bc", xd.dtype, (B, S, st), dev)
    ops.require(Cc, "Cc", xd.dtype, (B, S, st), dev)
    out = torch.empty_like(xd)
    if out.numel() == 0:
        return out
    if bf16 and any(t.data_ptr() % 16 for t in (xd, Bc, Cc)):
        raise ValueError("the bfloat16 kernel copies xd, Bc and Cc 16 bytes at a "
                         "time, which needs 16-byte aligned storage")
    err = ops.library().fedar_ssm_scan(
        xd.data_ptr(), logdecay.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        out.data_ptr(), B, S, nh, hd, st, int(bf16), ops.stream_ptr(xd))
    ops.check_launch(err, "ssm_scan")
    ssm_scan.launches += 1
    return out


ssm_scan.launches = 0


def kernel_attrs() -> dict:
    """The bf16 instance's resources: registers and spilled (local) bytes
    a thread, shared bytes and the blocks an SM holds at once, as
    ``cudaFuncGetAttributes`` and the occupancy API report them."""
    vals = [ctypes.c_int() for _ in range(4)]
    ops.check_launch(ops.library().fedar_ssm_scan_attrs(
        *(ctypes.byref(v) for v in vals)), "ssm_scan_attrs")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))
