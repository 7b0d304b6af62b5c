"""Kernels 1 and 4: fused masked local SGD for the FedAR client MLP.

ClientUpdate (Algorithm 2 lines 16-21) is the round's FLOP-dominant op:
every client runs E epochs of batch SGD on its local shard.  The CUDA
kernel (``csrc/local_sgd.cuh``; the narrow plan's instances are built in
``local_sgd.cu``, the wide one in ``local_sgd_wide.cu``) runs each
client's whole epochs x batches chain in one launch on a thread-block
cluster of K CTAs, each CTA owning
an HS-column slice of w1 (K and HS from ``plan``).  Up to H = 256 the slice
lives in shared memory: a width that no portable split of 8- or 16-column
slices covers is padded up to K x 16 columns, K <= 16.  Past 256 the wide
instance streams the slice from L2 (``plan`` reports it as ``streamed``):
HS is ceil(H / 16) rounded up to a multiple of 8, at most 64, so H runs up
to ``MAX_HIDDEN``, at batches of at most ``WIDE_MAX_BATCH``.  ``local_sgd``
takes the dense (R, n) sample rectangle and replaces the Pallas TPU kernel
``repro/kernels/local_sgd.py::local_sgd_fused``; ``local_sgd_ragged`` takes
the packed layout's batch-tile buffer, each client reading its own tiles,
and replaces ``local_sgd_fused_ragged``.  Both are one CUDA template, so a
client's row is bit-equal between the two.  Clusters take the clients
longest chain first (``longest_first``); the rows do not depend on that
order.  Their plain PyTorch versions are ``ref.local_sgd_ref`` and
``ref.local_sgd_ragged_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ops, ref


def longest_first(counts):
    """The int32 order of clients by descending chain length ``counts``
    (R,), ties in client order (a stable sort), computed where ``counts``
    lies, with no host sync."""
    return torch.sort(counts, descending=True, stable=True).indices.to(torch.int32)


def live_batches(mask, batch_size: int):
    """(R,) count of each client's batches, of ``batch_size`` samples
    along the (R, n) ``mask``, with at least one sample set (the steps an
    epoch of its local SGD runs)."""
    R, n = mask.shape
    nb = -(-n // batch_size)
    m = mask.to(torch.float32)
    if nb * batch_size != n:
        m = torch.nn.functional.pad(m, (0, nb * batch_size - n))
    return m.view(R, nb, batch_size).any(-1).sum(1)


def local_sgd(g_flat, x, y, act, mask, *, hidden: int, classes: int,
              lr: float, batch_size: int, epochs: int):
    """Every client's masked local SGD from the global flat row ``g_flat``.

    g_flat (D,) float32 in the flat order ``b1, b2, w1, w2``; x (R, n, I)
    float32; y (R, n) int32; act (R,) int32 (0=relu, 1=softmax); mask
    (R, n) bool or float32 validity (padding contributes zero gradient,
    all-padding batches are skipped).  The sample axis is zero-padded up to
    a whole number of batches (mask-False), matching the reference kernel's
    ceil batching.  Clusters take the clients in ``longest_first`` order of
    their live batches.  Returns the (R, D) post-SGD flat rows, float32.

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
    plan(I, H, C, B)
    _require_aligned(x, "x")
    out = torch.empty((R, D), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    order = longest_first(live_batches(m, B))
    err = lib.fedar_local_sgd(
        g_flat.data_ptr(), x.data_ptr(), y.data_ptr(), act.data_ptr(),
        m.data_ptr(), order.data_ptr(), out.data_ptr(), R, nb * B, I, H, C, B,
        epochs, lr, ops.stream_ptr(x),
    )
    ops.check_launch(err, "local_sgd")
    local_sgd.launches += 1
    return out


local_sgd.launches = 0

# The widest hidden layer the kernel takes: 16 CTAs (Hopper's non-portable
# cluster limit) of 64 columns, each column's w1 streamed from L2 by one
# lane of a 32-column group, two groups a CTA (see csrc/local_sgd.cuh).  The
# wide instance holds a batch's rows of a column in registers, at most
# WIDE_MAX_BATCH of them.
MAX_HIDDEN = 1024
WIDE_MAX_BATCH = 20


def plan(I: int, H: int, C: int, B: int) -> tuple[int, int, int, int, bool]:
    """The kernel's cluster size K, slice width HS (H padded to K * HS
    columns), threads a CTA, one CTA's dynamic shared bytes and whether w1
    streams from L2 (the wide instance, H > 256) for (I, H, C, B); raises
    for a shape that fits no plan."""
    K, HS, threads, smem, streamed = (ctypes.c_int() for _ in range(5))
    if ops.library().fedar_local_sgd_plan(I, H, C, B, ctypes.byref(K), ctypes.byref(HS),
                                          ctypes.byref(threads), ctypes.byref(smem),
                                          ctypes.byref(streamed)) != 0:
        raise ValueError(
            f"local_sgd kernel cannot take I={I}, H={H}, C={C}, B={B}: I must be "
            f"a multiple of 4 (16-byte rows for the bulk copy), H at most "
            f"{MAX_HIDDEN} (16 slices of at most 64 columns; past H = 256 w1 "
            f"streams from L2 and B is at most {WIDE_MAX_BATCH}), C at most 16")
    if smem.value > ops.MAX_SMEM_BYTES:
        raise ValueError(
            f"local_sgd kernel needs {smem.value} bytes of shared memory a CTA "
            f"for I={I}, H={H}, C={C}, B={B} (cluster of {K.value}); a block may "
            f"use {ops.MAX_SMEM_BYTES}")
    return K.value, HS.value, threads.value, smem.value, bool(streamed.value)


def kernel_attrs(I: int, H: int, C: int, B: int) -> dict:
    """The dense instance's resources at (I, H, C, B): cluster size, slice
    width, threads and dynamic shared bytes a CTA, whether w1 streams from
    L2, registers and spilled (local) bytes a thread as
    ``cudaFuncGetAttributes`` reports them, and the clusters that fit on
    the card at once (``cudaOccupancyMaxActiveClusters``).  Raises if no
    cluster fits: the kernel could not launch at this plan."""
    K, HS, threads, smem, streamed = plan(I, H, C, B)
    vals = [ctypes.c_int() for _ in range(3)]
    ops.check_launch(ops.library().fedar_local_sgd_attrs(
        I, H, C, B, *(ctypes.byref(v) for v in vals)), "local_sgd_attrs")
    attrs = dict(cluster=K, slice=HS, threads=threads, dynamic_smem=smem,
                 streamed=streamed,
                 **dict(zip(("registers", "local_bytes", "max_clusters"),
                            (v.value for v in vals))))
    if attrs["max_clusters"] < 1:
        raise ValueError(f"local_sgd kernel: no cluster of {K} CTAs with {smem} shared "
                         f"bytes each fits this card at H={H}")
    return attrs


def _require_aligned(t, name):
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary for the bulk copy")


def local_sgd_ragged(g_flat, xt, yt, mt, act, nb, off, *, hidden: int,
                     classes: int, lr: float, epochs: int):
    """Every client's masked local SGD over a ragged batch-tile buffer:
    client r runs E epochs over its ``nb[r]`` tiles ``xt[off[r] : off[r] +
    nb[r]]``; a tile whose mask count is zero is skipped, and a client with
    ``nb == 0`` keeps the global row.

    g_flat (D,) float32 (flat order ``b1, b2, w1, w2``); xt (T, B, I)
    float32; yt (T, B) int32; mt (T, B) bool or float32 validity; act, nb,
    off (R,) int32, each client's tiles within the buffer (checked: one
    device-to-host read of a flag per call).  Clusters take the clients in
    ``longest_first(nb)`` order.  Returns the (R, D) post-SGD flat rows,
    float32.

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
    plan(I, H, C, B)
    _require_aligned(xt, "xt")
    out = torch.empty((R, D), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    if bool(((nb < 0) | (off < 0) | (off.to(torch.int64) + nb > T)).any()):
        raise ValueError(f"nb / off address tiles outside the {T}-tile buffer")
    order = longest_first(nb)
    err = lib.fedar_local_sgd_ragged(
        g_flat.data_ptr(), xt.data_ptr(), yt.data_ptr(), act.data_ptr(),
        m.data_ptr(), nb.data_ptr(), off.data_ptr(), order.data_ptr(),
        out.data_ptr(), R, I, H, C, B, epochs, lr, ops.stream_ptr(xt),
    )
    ops.check_launch(err, "local_sgd_ragged")
    local_sgd_ragged.launches += 1
    return out


local_sgd_ragged.launches = 0
