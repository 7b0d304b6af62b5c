"""Kernel 2: trust-weighted, staleness-decayed federated aggregation,
``out[d] = sum_n w[n] * (1 + tau[n])^-1/2 * deltas[n, d]``.

The CUDA kernel (``csrc/fedavg_agg.cu``) is a streaming column reduction;
it replaces the Pallas TPU kernel ``repro/kernels/fedavg_agg.py::fedavg_agg``.
Its plain PyTorch version is ``ref.fedavg_agg_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref


def fedavg_agg(deltas, weights, *, staleness=None):
    """deltas (N, D) float32; weights (N,) float32; staleness optional (N,)
    float32 rounds each update waited (``None``: all fresh).  Returns (D,)
    float32.  On CPU tensors this is the plain version; on CUDA tensors it
    launches the kernel."""
    if not deltas.is_cuda:
        return ref.fedavg_agg_ref(deltas, weights, staleness)
    dev = deltas.device
    if deltas.dim() != 2:
        raise ValueError(f"deltas must be (N, D), got {tuple(deltas.shape)}")
    N, D = deltas.shape
    ops.require(deltas, "deltas", torch.float32, (N, D), dev)
    ops.require(weights, "weights", torch.float32, (N,), dev)
    if staleness is not None:
        ops.require(staleness, "staleness", torch.float32, (N,), dev)
    out = torch.empty((D,), dtype=torch.float32, device=dev)
    if D == 0:
        return out
    lib = ops.library()
    err = lib.fedar_fedavg_agg(
        deltas.data_ptr(), weights.data_ptr(),
        None if staleness is None else staleness.data_ptr(),
        out.data_ptr(), N, D, ops.stream_ptr(deltas),
    )
    ops.check_launch(err, "fedavg_agg")
    fedavg_agg.launches += 1
    return out


fedavg_agg.launches = 0
