"""Kernel 9: Mamba2's chunked state-space dual (SSD) scan, for the LM
trunk's prefill.

The CUDA kernel (``csrc/ssm_scan.cu``) replaces the Pallas TPU kernel
``repro/kernels/ssm_scan.py::ssm_scan``; its plain PyTorch version is
``ref.ssm_scan_ref``, the sequential recurrence.  The kernel chunks by 64
positions (the reference's kernel by ``cfg.ssm_chunk``), which changes the
result only by rounding order, and takes any S.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref

MAX_DIM = 64  # largest head_dim and state the kernel takes
_DTYPES = (torch.float32, torch.bfloat16)


def ssm_scan(xd, logdecay, Bc, Cc):
    """xd (B, S, nh, hd) dt-scaled inputs; logdecay (B, S, nh) float32;
    Bc, Cc (B, S, st) in xd's dtype.  Returns y (B, S, nh, hd) in xd's
    dtype, with ``state_t = exp(logdecay_t) state_{t-1} + B_t (x) x_t`` and
    ``y_t = C_t . state_t`` from a zero state.  On CPU tensors this is the
    plain version; on CUDA tensors it launches the kernel, which takes
    float32 or bfloat16 and hd, st <= 64."""
    if xd.dim() != 4 or Bc.dim() != 3:
        raise ValueError(f"xd must be (B, S, nh, hd) and Bc (B, S, st), got "
                         f"{tuple(xd.shape)}, {tuple(Bc.shape)}")
    if not xd.is_cuda:
        return ref.ssm_scan_ref(xd, logdecay, Bc, Cc).to(xd.dtype)
    B, S, nh, hd = xd.shape
    st = Bc.shape[-1]
    if xd.dtype not in _DTYPES:
        raise ValueError(f"xd has dtype {xd.dtype}; the kernel takes {list(_DTYPES)}")
    if not (1 <= hd <= MAX_DIM and 1 <= st <= MAX_DIM):
        raise ValueError(f"head_dim {hd} and state {st} must be in 1..{MAX_DIM}")
    dev = xd.device
    ops.require(xd, "xd", xd.dtype, (B, S, nh, hd), dev)
    ops.require(logdecay, "logdecay", torch.float32, (B, S, nh), dev)
    ops.require(Bc, "Bc", xd.dtype, (B, S, st), dev)
    ops.require(Cc, "Cc", xd.dtype, (B, S, st), dev)
    out = torch.empty_like(xd)
    if out.numel() == 0:
        return out
    err = ops.library().fedar_ssm_scan(
        xd.data_ptr(), logdecay.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        out.data_ptr(), B, S, nh, hd, st, int(xd.dtype == torch.bfloat16),
        ops.stream_ptr(xd))
    ops.check_launch(err, "ssm_scan")
    ssm_scan.launches += 1
    return out


ssm_scan.launches = 0
