"""Kernels 1 and 4: fused masked local SGD for the FedAR client MLP.

ClientUpdate (Algorithm 2 lines 16-21) is the round's FLOP-dominant op:
every client runs E epochs of batch SGD on its local shard.  The CUDA
kernel (``csrc/local_sgd.cuh``; built as ``local_sgd.cu``,
``local_sgd_wide.cu``, ``local_sgd_tiled.cu`` and ``local_sgd_general.cu``,
one file an instance) runs each client's whole epochs x batches chain in
one launch on a thread-block cluster of K CTAs, each CTA owning an
HS-column slice of the hidden layer (K and HS from ``plan``).  ``plan``
picks the instance from the shapes alone, the first that takes the shape:

  narrow   H <= 256 at I a multiple of 4, C <= 16 and a batch whose two x
           tiles fit a CTA's shared memory (B <= 20 at I = 784): the w1
           slice in shared memory, H padded up to K x 16 columns, K <= 16
           where no split of 8 or 16 columns covers it;
  wide     257 <= H <= 1,024 at the same I and C, B <= 20: a portable
           cluster of K <= 8 slices of 64 or 128 columns, the w1 slice in
           place in the client's output row and streamed each step through
           a ring of row chunks in shared memory (``Plan.ring`` slots), an
           update and a forward role of 4 warps each with register tiles
           of 4 columns x 4 rows of I (256 threads a CTA);
  tiled    H <= 256 at the same I and C, a batch the narrow plan cannot
           hold (every B from 21 up at I = 784, H <= 256): the narrow
           plan's cluster, slices and shared-memory layout, the batch
           through in sub-tiles of up to 20 rows (``Plan.rows``), the
           gradients summed over the sub-tiles before one update, each
           thread's share of w1's in its registers; it takes a shape
           whose plan fits a CTA's shared memory at I <= 1,024 (16-column
           slices) or 2,048 (8-column);
  general  every other shape (C > 16, I not a multiple of 4, H > 1,024,
           H > 256 at B > 20, and what the tiled plan cannot fit): x read
           in sub-tiles of batch rows, the per-row temporaries in a
           workspace in global memory, one slot for each resident cluster
           (``torch.empty`` on the call's device).

What bounded the wide instance's first design (a lane owning one w1
column, 15-16 slices a client, 7 clusters resident) was its pass over w1,
measured at ~13.5 of a 28 us step at H = 512: each float4 of x read from
shared memory fed 4 FMAs.  Its register tiles feed 16, and twice as many
clusters run at once.  What holds its pass up now, timed on the card with
stripped copies of the kernel, is the ring's 4-byte copies in and out, not
the FMAs and not the slice's bytes through L2: without the copies the
kernel ran about a third faster, without either role's FMAs 11-15% (PERF.md
section 7).

What bounds the tiled plan on an H100 is what bounds the narrow one: the
chain's step latency, not the 16-column slice's FMA work (~1.0 MFLOP a CTA
a 20-row sub-tile at I = 784, H = 128, ~2 us at an SM's share of the fp32
peak, against the ~12 us a narrow step at B = 20 takes on the card,
PERF.md section 6).  A step of B rows costs ceil(B / 20) narrow steps'
latency, so on a given fleet the kernel's time stays near the narrow
plan's at B = 20.

Together they take every shape of the reference's envelope,
``fused_fits_vmem``, and more; ``plan`` raises only for a dimension under 1
or a workspace slot or output row past 2^31 floats.  ``local_sgd`` takes the
dense (R, n) sample rectangle and replaces the Pallas TPU kernel
``repro/kernels/local_sgd.py::local_sgd_fused``; ``local_sgd_ragged`` takes
the packed layout's batch-tile buffer, each client reading its own tiles,
and replaces ``local_sgd_fused_ragged``.  Both are one CUDA template in
each instance, so a client's row is bit-equal between the two.  Clusters
take the clients longest chain first (``longest_first``); the rows do not
depend on that order.  Their plain PyTorch versions are
``ref.local_sgd_ref`` and ``ref.local_sgd_ragged_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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
    p = plan(I, H, C, B)
    if p.instance != "general":
        _require_aligned(x, "x")
    out = torch.empty((R, D), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    order = longest_first(live_batches(m, B))
    ws, nclusters = _workspace(p, I, H, C, B, R, dev)
    err = lib.fedar_local_sgd(
        g_flat.data_ptr(), x.data_ptr(), y.data_ptr(), act.data_ptr(),
        m.data_ptr(), order.data_ptr(), out.data_ptr(), _ptr(ws), nclusters, R,
        nb * B, I, H, C, B, epochs, lr, ops.stream_ptr(x),
    )
    ops.check_launch(err, "local_sgd")
    local_sgd.launches += 1
    return out


local_sgd.launches = 0

# The reference's per-client VMEM budget (``repro/kernels/local_sgd.py``):
# its fused route takes a shape whose working set fits it.  Nothing here
# routes on it; it names the envelope in errors and tests.
VMEM_BUDGET_BYTES = 8 * 1024 * 1024

INSTANCES = ("narrow", "wide", "general", "tiled")


def fused_fits_vmem(n: int, input_dim: int, hidden: int, classes: int,
                    budget: int = VMEM_BUDGET_BYTES) -> bool:
    """Whether one client's working set -- the (n, input_dim) sample slab,
    the in/out parameter tiles and the per-batch temporaries -- fits the
    reference kernel's per-grid-step VMEM budget (its envelope; the port's
    plan takes every shape inside it)."""
    slab = n * input_dim + 2 * n
    params = 2 * (input_dim * hidden + hidden + hidden * classes + classes)
    grads = input_dim * hidden + hidden * classes
    return 4 * (slab + params + grads) <= budget


class Plan(NamedTuple):
    """The kernel's plan for one shape: cluster size K, slice width HS (H
    padded to K * HS columns), threads and dynamic shared bytes a CTA,
    whether w1 streams from L2, the instance (``INSTANCES``), the batch rows
    a sub-tile (the tiled plan and the general instance; B for the others),
    the floats of one cluster's workspace slot (the general instance; 0 for
    the others) and the slots of the wide instance's ring of w1 chunks (0
    for the others)."""
    cluster: int
    slice: int
    threads: int
    smem_bytes: int
    streamed: bool
    instance: str
    rows: int
    workspace: int
    ring: int


def plan(I: int, H: int, C: int, B: int) -> Plan:
    """The kernel's plan for (I, H, C, B), chosen from the shapes alone;
    raises for a shape no instance takes."""
    ints = [ctypes.c_int() for _ in range(8)]
    ws = ctypes.c_longlong()
    if ops.library().fedar_local_sgd_plan(I, H, C, B, *(ctypes.byref(v) for v in ints),
                                          ctypes.byref(ws)) != 0:
        inside = fused_fits_vmem(B, I, H, C)
        raise ValueError(
            f"local_sgd kernel cannot take I={I}, H={H}, C={C}, B={B}: a "
            f"dimension is under 1, or one cluster's workspace slot or one "
            f"output row would pass 2^31 floats (the reference's envelope, "
            f"fused_fits_vmem, {'holds' if inside else 'does not hold'} it)")
    inst, K, HS, threads, smem, streamed, rows, ring = (v.value for v in ints)
    return Plan(K, HS, threads, smem, bool(streamed), INSTANCES[inst], rows, ws.value, ring)


@functools.lru_cache(maxsize=None)
def _attrs(I: int, H: int, C: int, B: int, device: int) -> tuple:
    vals = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(device):
        ops.check_launch(ops.library().fedar_local_sgd_attrs(
            I, H, C, B, *(ctypes.byref(v) for v in vals)), "local_sgd_attrs")
    return tuple(v.value for v in vals)


def kernel_attrs(I: int, H: int, C: int, B: int) -> dict:
    """The dense form's resources at (I, H, C, B): ``plan``'s fields,
    registers and spilled (local) bytes a thread as
    ``cudaFuncGetAttributes`` reports them, and the clusters that fit on
    the card at once (``cudaOccupancyMaxActiveClusters``).  Raises if no
    cluster fits: the kernel could not launch at this plan."""
    p = plan(I, H, C, B)
    regs, local, clusters = _attrs(I, H, C, B, torch.cuda.current_device())
    attrs = dict(cluster=p.cluster, slice=p.slice, threads=p.threads,
                 dynamic_smem=p.smem_bytes, streamed=p.streamed, instance=p.instance,
                 rows=p.rows, workspace=p.workspace, ring=p.ring, registers=regs,
                 local_bytes=local,
                 max_clusters=clusters)
    if clusters < 1:
        raise ValueError(f"local_sgd kernel: no cluster of {p.cluster} CTAs with "
                         f"{p.smem_bytes} shared bytes each fits this card at H={H}")
    return attrs


def _workspace(p: Plan, I: int, H: int, C: int, B: int, R: int, dev):
    """The general instance's workspace, one slot for each cluster of its
    grid (as many as fit on the card at once, at most R), and the grid in
    clusters; (None, 0) for the other instances.  The caller holds the
    tensor until the launch is queued."""
    if p.instance != "general":
        return None, 0
    nclusters = min(R, kernel_attrs(I, H, C, B)["max_clusters"])
    return torch.empty(nclusters * p.workspace, dtype=torch.float32, device=dev), nclusters


def _ptr(t):
    return None if t is None else t.data_ptr()


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
    p = plan(I, H, C, B)
    if p.instance != "general":
        _require_aligned(xt, "xt")
    out = torch.empty((R, D), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    if bool(((nb < 0) | (off < 0) | (off.to(torch.int64) + nb > T)).any()):
        raise ValueError(f"nb / off address tiles outside the {T}-tile buffer")
    order = longest_first(nb)
    ws, nclusters = _workspace(p, I, H, C, B, R, dev)
    err = lib.fedar_local_sgd_ragged(
        g_flat.data_ptr(), xt.data_ptr(), yt.data_ptr(), act.data_ptr(),
        m.data_ptr(), nb.data_ptr(), off.data_ptr(), order.data_ptr(),
        out.data_ptr(), _ptr(ws), nclusters, R, I, H, C, B, epochs, lr,
        ops.stream_ptr(xt),
    )
    ops.check_launch(err, "local_sgd_ragged")
    local_sgd_ragged.launches += 1
    return out


local_sgd_ragged.launches = 0
