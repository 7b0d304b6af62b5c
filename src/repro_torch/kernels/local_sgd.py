"""Kernels 1 and 4: fused masked local SGD for the FedAR client MLP.

ClientUpdate (Algorithm 2 lines 16-21) is the round's FLOP-dominant op:
every client runs E epochs of batch SGD on its local shard.  The CUDA
kernel (``csrc/local_sgd.cu``, one thread block per client) runs each
client's whole epochs x batches loop in one launch.  ``local_sgd`` takes the
dense (R, n) sample rectangle and replaces the Pallas TPU kernel
``repro/kernels/local_sgd.py::local_sgd_fused``; ``local_sgd_ragged`` takes
the packed layout's batch-tile buffer, each client reading its own tiles,
and replaces ``local_sgd_fused_ragged``.  Both are one CUDA template, so a
client's row is bit-equal between the two.  Their plain PyTorch versions
are ``ref.local_sgd_ref`` and ``ref.local_sgd_ragged_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref


def local_sgd(g_flat, x, y, act, mask, *, hidden: int, classes: int,
              lr: float, batch_size: int, epochs: int):
    """Every client's masked local SGD from the global flat row ``g_flat``.

    g_flat (D,) float32 in the flat order ``b1, b2, w1, w2``; x (R, n, I)
    float32; y (R, n) int32; act (R,) int32 (0=relu, 1=softmax); mask
    (R, n) bool or float32 validity (padding contributes zero gradient,
    all-padding batches are skipped).  The sample axis is zero-padded up to
    a whole number of batches (mask-False), matching the reference kernel's
    ceil batching.  Returns the (R, D) post-SGD flat rows, float32.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel, or raises if the shapes do not fit it."""
    if not x.is_cuda:
        return ref.local_sgd_ref(g_flat, x, y, act, mask, hidden=hidden,
                                 classes=classes, lr=lr,
                                 batch_size=batch_size, epochs=epochs)
    dev = x.device
    R, n, I = x.shape
    H, C, B = hidden, classes, batch_size
    D = H + C + I * H + H * C
    ops.require(g_flat, "g_flat", torch.float32, (D,), dev)
    ops.require(x, "x", torch.float32, (R, n, I), dev)
    ops.require(y, "y", torch.int32, (R, n), dev)
    ops.require(act, "act", torch.int32, (R,), dev)
    if mask.dtype not in (torch.bool, torch.float32):
        raise ValueError(f"mask has dtype {mask.dtype}, expected bool or float32")
    m = mask.to(torch.float32)
    ops.require(m, "mask", torch.float32, (R, n), dev)
    if B < 1 or epochs < 0:
        raise ValueError(f"batch_size={B}, epochs={epochs}")
    nb = -(-n // B)
    pad = nb * B - n
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        y = torch.nn.functional.pad(y, (0, pad))
        m = torch.nn.functional.pad(m, (0, pad))
    lib = ops.library()
    smem = _smem_bytes(lib, I, H, C, B)
    out = torch.empty((R, D), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    err = lib.fedar_local_sgd(
        g_flat.data_ptr(), x.data_ptr(), y.data_ptr(), act.data_ptr(),
        m.data_ptr(), out.data_ptr(), R, nb * B, I, H, C, B, epochs, lr,
        smem, ops.stream_ptr(x),
    )
    ops.check_launch(err, "local_sgd")
    local_sgd.launches += 1
    return out


local_sgd.launches = 0


def _smem_bytes(lib, I: int, H: int, C: int, B: int) -> int:
    smem = lib.fedar_local_sgd_smem_bytes(I, H, C, B)
    if smem > ops.MAX_SMEM_BYTES:
        raise ValueError(
            f"local_sgd kernel needs {smem} bytes of shared memory for "
            f"I={I}, H={H}, C={C}, B={B}; a block may use {ops.MAX_SMEM_BYTES}"
        )
    return smem


def local_sgd_ragged(g_flat, xt, yt, mt, act, nb, off, *, hidden: int,
                     classes: int, lr: float, epochs: int):
    """Every client's masked local SGD over a ragged batch-tile buffer:
    client r runs E epochs over its ``nb[r]`` tiles ``xt[off[r] : off[r] +
    nb[r]]``; a tile whose mask count is zero is skipped, and a client with
    ``nb == 0`` keeps the global row.

    g_flat (D,) float32 (flat order ``b1, b2, w1, w2``); xt (T, B, I)
    float32; yt (T, B) int32; mt (T, B) bool or float32 validity; act, nb,
    off (R,) int32, each client's tiles within the buffer (checked: one
    device-to-host read of a flag per call).  Returns the (R, D) post-SGD
    flat rows, float32.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel, or raises if the shapes do not fit it."""
    if not xt.is_cuda:
        return ref.local_sgd_ragged_ref(g_flat, xt, yt, mt, act, nb, off,
                                        hidden=hidden, classes=classes,
                                        lr=lr, epochs=epochs)
    dev = xt.device
    T, B, I = xt.shape
    R = act.shape[0]
    H, C = hidden, classes
    D = H + C + I * H + H * C
    ops.require(g_flat, "g_flat", torch.float32, (D,), dev)
    ops.require(xt, "xt", torch.float32, (T, B, I), dev)
    ops.require(yt, "yt", torch.int32, (T, B), dev)
    if mt.dtype not in (torch.bool, torch.float32):
        raise ValueError(f"mt has dtype {mt.dtype}, expected bool or float32")
    m = mt.to(torch.float32)
    ops.require(m, "mt", torch.float32, (T, B), dev)
    for t, name in ((act, "act"), (nb, "nb"), (off, "off")):
        ops.require(t, name, torch.int32, (R,), dev)
    if B < 1 or epochs < 0:
        raise ValueError(f"batch_size={B}, epochs={epochs}")
    lib = ops.library()
    smem = _smem_bytes(lib, I, H, C, B)
    out = torch.empty((R, D), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    if bool(((nb < 0) | (off < 0) | (off.to(torch.int64) + nb > T)).any()):
        raise ValueError(f"nb / off address tiles outside the {T}-tile buffer")
    err = lib.fedar_local_sgd_ragged(
        g_flat.data_ptr(), xt.data_ptr(), yt.data_ptr(), act.data_ptr(),
        m.data_ptr(), nb.data_ptr(), off.data_ptr(), out.data_ptr(), R, I, H,
        C, B, epochs, lr, smem, ops.stream_ptr(xt),
    )
    ops.check_launch(err, "local_sgd_ragged")
    local_sgd_ragged.launches += 1
    return out


local_sgd_ragged.launches = 0
