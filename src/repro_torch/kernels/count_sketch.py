"""The defense's count sketch D -> r in a fixed summation order, with its
tables in O(D) memory.

Coordinate d adds ``sign[d] * x[d]`` into bucket ``bucket[d]``.  The
tables are kept per chunk of ``SKETCH_CHUNK`` coordinates, sorted by
bucket: ``ent`` (D,) int16 holds each coordinate's offset within its chunk
in bucket order, bit 15 set where the sign is -1, and ``start`` (chunks, r
+ 1) int16 where each bucket's run begins; 2.25 bytes a coordinate at r =
256.  The CUDA kernel (``csrc/count_sketch.cu``) sums every output in the
tables' order, so two runs on the same rows are bit-equal; it replaces no
TPU kernel (the reference sketches with an XLA scatter,
``src/repro/core/defense.py``).  The plain version, ``count_sketch_ref``,
is the reference's scatter-add (``index_add_``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

SKETCH_CHUNK = 2048  # coordinates a chunk (csrc/count_sketch.cu kChunk)
SKETCH_ROWS = 4  # rows a block of pass 1 (kRows)
SKETCH_SEGMENTS = 4096  # most segments of consecutive chunks (pass 1's grid)
_SLICE_CHUNKS = 1 << 15  # chunks the table build sorts at a time


def sketch_tables(bucket, sign, r: int, device):
    """(ent, start) on ``device`` from the (D,) bucket (ints in [0, r)) and
    sign (+-1) arrays (numpy or tensors), built a slice of chunks at a time
    so that the build holds a few bytes a coordinate beyond the tables."""
    if not 1 <= r <= 1 << 13:
        raise ValueError(f"the count sketch takes 1 <= r <= 8192 buckets, got {r}")
    D, C = len(bucket), SKETCH_CHUNK
    n_chunks = -(-D // C)
    ent = torch.empty(D, dtype=torch.int16, device=device)
    start = torch.zeros((n_chunks, r + 1), dtype=torch.int16, device=device)
    for c0 in range(0, n_chunks, _SLICE_CHUNKS):
        d0, d1 = c0 * C, min(D, (c0 + _SLICE_CHUNKS) * C)
        b = torch.as_tensor(bucket[d0:d1]).to(device=device, dtype=torch.int64)
        neg = torch.as_tensor(sign[d0:d1]).to(device) < 0
        key = torch.arange(d1 - d0, device=device) // C * r + b
        key, order = torch.sort(key, stable=True)
        ent[d0:d1] = (order % C - 32768 * neg[order].to(torch.int64)).to(torch.int16)
        nc = -(-(d1 - d0) // C)
        counts = torch.bincount(key, minlength=nc * r).view(nc, r)
        start[c0:c0 + nc, 1:] = counts.cumsum(1).to(torch.int16)
    return ent, start


def decode_tables(ent, start):
    """The tables' (D,) bucket (int64) and sign (float32 +-1)."""
    D, C = ent.shape[0], SKETCH_CHUNK
    n_chunks, r = start.shape[0], start.shape[1] - 1
    counts = (start[:, 1:] - start[:, :-1]).to(torch.int64).reshape(-1)
    in_order = torch.arange(r, device=ent.device).repeat(n_chunks).repeat_interleave(counts)
    e = ent.to(torch.int64)
    coord = torch.arange(D, device=ent.device) // C * C + (e & 0x7FFF)
    bucket = torch.empty(D, dtype=torch.int64, device=ent.device)
    sign = torch.empty(D, dtype=torch.float32, device=ent.device)
    bucket[coord] = in_order
    sign[coord] = torch.where(e < 0, -1.0, 1.0)
    return bucket, sign


def sketch_plan(dim: int) -> tuple:
    """(segments, chunks a segment) of pass 1: at most ``SKETCH_SEGMENTS``
    segments of consecutive chunks, fixed by D alone."""
    n_chunks = -(-dim // SKETCH_CHUNK)
    per_seg = -(-n_chunks // min(n_chunks, SKETCH_SEGMENTS))
    return -(-n_chunks // per_seg), per_seg


def count_sketch_ref(rows, bucket, sign, r: int):
    """The reference's scatter-add: (n, D) -> (n, r) float32."""
    out = torch.zeros((rows.shape[0], r), dtype=torch.float32, device=rows.device)
    return out.index_add_(1, bucket, rows.to(torch.float32) * sign)


def count_sketch(rows, ent, start):
    """rows (n, D) float32 -> (n, r) float32.  On CPU tensors this is the
    plain version (the tables decoded, then ``count_sketch_ref``); on CUDA
    tensors it launches the kernel (two passes, one call)."""
    r = start.shape[1] - 1
    if not rows.is_cuda:
        return count_sketch_ref(rows, *decode_tables(ent, start), r)
    if rows.dim() != 2:
        raise ValueError(f"rows must be (n, D), got {tuple(rows.shape)}")
    n, D = rows.shape
    dev = rows.device
    ops.require(rows, "rows", torch.float32, (n, D), dev)
    ops.require(ent, "ent", torch.int16, (D,), dev)
    ops.require(start, "start", torch.int16, (-(-D // SKETCH_CHUNK), r + 1), dev)
    if not n < 65535 * SKETCH_ROWS:
        raise ValueError(f"the kernel takes fewer than {65535 * SKETCH_ROWS} rows, got {n}")
    out = torch.empty((n, r), dtype=torch.float32, device=dev)
    if n == 0 or D == 0:
        return out.zero_()
    segs, per_seg = sketch_plan(D)
    partial = (torch.empty((segs, n, r), dtype=torch.float32, device=dev)
               if segs > 1 else None)
    err = ops.library().fedar_count_sketch(
        rows.data_ptr(), ent.data_ptr(), start.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), n, D, r, segs, per_seg,
        ops.stream_ptr(rows))
    ops.check_launch(err, "count_sketch")
    count_sketch.launches += 1
    return out


count_sketch.launches = 0
