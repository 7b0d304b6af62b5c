"""The top-k decode's launch plan and its windowed scatter, on the CPU.

``kernels/compress.py::topk_plan`` cuts the flat (N, D) output into
windows of ``TOPK_WINDOW`` floats; the CUDA kernel zeroes each window in shared
memory, adds the pairs of every row it spans that land inside it, and
writes it out once (a bulk copy, plus plain stores for the last window's
remainder of up to 3 floats).  The kernel runs only on the card
(``tests/test_torch_cuda.py``).  Here:

- the plan covers the output exactly once, every window starts 16-byte
  aligned, and its row count and shared bytes are right;
- an emulation of the kernel's windowed scatter, written here in torch
  and following the plan, is bit-equal to the port's plain version, the
  reference's plain version and (where values are finite) the Pallas body
  in interpret mode, for distinct indices, pairs, windows that straddle
  rows, many rows a window, D < k, indices out of range, and k = 0, at the
  plan's window and (the emulation's own argument) at windows of a few
  floats, where every window meets several rows;
- a NaN or an inf stays on its own element, as in both plain versions
  and the Pallas body under jit; the body's arithmetic op by op spreads
  it over its row (pinned here as the reference's divergence: such a row
  is quarantined either way, ``core/engine.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import compress as jkernels
from repro.kernels import ref as jref
from repro_torch.kernels import compress as codec
from repro_torch.kernels import ops, ref
from repro_torch.kernels.compress import topk_plan

MAIN = (101770, 101771)  # the MLP's D (D * 4 is 8 mod 16), and an odd D


# ------------------------------------------------------------ the plan
def _windows(p, N, D):
    starts = np.arange(p["windows"], dtype=np.int64) * p["window"]
    ends = np.minimum(starts + p["window"], N * D)
    return starts, ends


def _rows_per_window(starts, ends, N, D, window):
    """Rows a window spans, counted from the row boundaries: 1 plus the
    row starts strictly inside it (independent of the plan's arithmetic)."""
    inner = np.arange(1, N, dtype=np.int64) * D
    inner = inner[inner % window != 0]  # a row starting a window adds none
    return 1 + np.bincount(inner // window, minlength=len(starts))[:len(starts)]


@pytest.mark.parametrize("N,k,D", [
    (512, 3180, MAIN[0]),
    (12, 3180, MAIN[0]),
    (12, 3180, MAIN[1]),
    (512, 3180, MAIN[1]),
    (33, 3181, MAIN[1]),  # the last window ends in 3 floats of remainder
    (64, 3, 5),      # one window spans every row
    (4096, 64, 64),  # 32 windows of 128 rows
    (8, 20, 7),      # D < k
    (3, 2, 5000),    # windows start mid-row
    (1, 1, 1),
], ids=["n512", "n12", "n12-odd", "n512-odd", "tail", "d5", "many-rows",
        "d-lt-k", "straddle", "one"])
def test_topk_plan_covers_the_output_once(N, k, D):
    p = topk_plan(N, k, D)
    window = p["window"]
    assert window == codec.TOPK_WINDOW and window % 4 == 0
    starts, ends = _windows(p, N, D)
    assert starts[0] == 0 and ends[-1] == N * D
    np.testing.assert_array_equal(ends[:-1], starts[1:])  # no gap, no overlap
    lens = ends - starts
    assert (lens > 0).all() and (lens <= window).all()
    assert (lens[:-1] == window).all()  # only the last window is short
    assert ((starts * 4) % 16 == 0).all()  # 16-byte aligned from the output's base
    rows = _rows_per_window(starts, ends, N, D, window)
    assert p["rows_per_window_max"] == rows.max()
    assert p["buffers"] == 2 and p["threads"] == 256
    assert p["smem_bytes"] == p["buffers"] * window * 4 <= ops.MAX_SMEM_BYTES
    assert 1 <= p["blocks"] <= p["windows"]


def test_topk_plan_at_the_main_path_shapes():
    """N = 512 at D = 101,770: 6,361 windows of 8,192 floats, three 64 KB
    blocks an SM on 132 SMs, at most two rows a window; N = 12: a block a
    window (150)."""
    p = topk_plan(512, 3180, MAIN[0])
    assert (p["window"], p["windows"], p["blocks"], p["smem_bytes"],
            p["rows_per_window_max"]) == (8192, 6361, 396, 65536, 2)
    p = topk_plan(12, 3180, MAIN[0])
    assert (p["windows"], p["blocks"]) == (150, 150)
    p = topk_plan(12, 3180, MAIN[0], sms=4)
    assert p["blocks"] == 12  # a persistent grid: 4 SMs x 3 blocks
    assert topk_plan(0, 5, 7)["windows"] == topk_plan(3, 5, 0)["blocks"] == 0


# ---------------------------------------------- the windowed scatter
def emulate(vals, idx, D, *, window=codec.TOPK_WINDOW):
    """The kernel's algorithm in torch, window by window over the flat
    output, as ``topk_plan`` cuts it at its window: zero the window, add
    every kept pair of the rows it spans in pair order, write its body and
    its remainder.  ``window``, a multiple of 4, is the emulation's own."""
    N, k = vals.shape
    out = torch.full((N * D,), float("nan"))  # every element must be written
    if k == 0:
        return out.zero_().view(N, D)
    windows = -(-N * D // window)
    if window == codec.TOPK_WINDOW:
        assert windows == topk_plan(N, k, D)["windows"]
    for w in range(windows):
        w0 = w * window
        length = min(window, N * D - w0)
        buf = torch.zeros(window)
        for r in range(w0 // D, (w0 + length - 1) // D + 1):
            lo, hi = max(0, w0 - r * D), min(D, w0 + length - r * D)
            c = idx[r].to(torch.int64)
            keep = (c >= lo) & (c < hi)  # also drops indices outside [0, D)
            buf.index_add_(0, r * D - w0 + c[keep], vals[r][keep])
        body = length & ~3
        out[w0:w0 + body] = buf[:body]
        out[w0 + body:w0 + length] = buf[body:length]
    return out.view(N, D)


# (N, k, D, window): windows of a few floats, each meeting several rows,
# then the same kinds of case at the plan's window
W = codec.TOPK_WINDOW
_SHAPES = {"distinct": (6, 9, 97, 16), "pairs": (6, 12, 97, 16),
           "straddle": (7, 4, 10, 8), "many-rows": (64, 3, 5, 12),
           "d-lt-k": (8, 20, 7, 8), "main-shape": (12, 3180, MAIN[1], W),
           "out-of-range": (5, 8, 23, 12), "pairs-w": (4, 200, 5003, W),
           "straddle-w": (3, 40, 5000, W), "many-rows-w": (300, 3, 64, W),
           "tail-w": (7, 5, 1171, W), "d-lt-k-w": (2000, 20, 7, W),
           "out-of-range-w": (3, 8, 5001, W)}
_CASES = tuple(_SHAPES)


def _case(name):
    rng = np.random.default_rng(_CASES.index(name))
    N, k, D, window = _SHAPES[name]
    vals = rng.standard_normal((N, k)).astype(np.float32)
    kind = name.removesuffix("-w")
    if kind in ("pairs", "d-lt-k"):
        # pairs of one index (d-lt-k: up to triples and more), which add
        idx = rng.integers(0, D, (N, k)) if kind == "d-lt-k" else np.concatenate(
            [np.stack([rng.permutation(D)[:k // 2] for _ in range(N)])] * 2, axis=1)
    else:
        idx = np.stack([rng.permutation(D)[:k] for _ in range(N)])
    if kind == "out-of-range":
        idx[0, 2], idx[2, 5], idx[-1, 0] = D, D + 7, 2**31 - 1
    return vals, idx.astype(np.int32), D, window


@pytest.mark.parametrize("name", _CASES)
def test_windowed_scatter_matches_the_plain_versions(name):
    vals, idx, D, window = _case(name)
    got = emulate(torch.as_tensor(vals), torch.as_tensor(idx), D, window=window)
    want = np.asarray(jref.topk_decode_ref(jnp.asarray(vals), jnp.asarray(idx), D))
    np.testing.assert_array_equal(got.numpy(), want)
    valid = (idx >= 0) & (idx < D)
    # the port's plain version raises on an index out of range: hold it on
    # the in-range pairs (a dropped pair adds 0 to column 0)
    plain = ref.topk_decode_ref(torch.as_tensor(np.where(valid, vals, 0.0)),
                                torch.as_tensor(np.where(valid, idx, 0)), D)
    assert torch.equal(got, plain)
    if not valid.all():
        with pytest.raises(RuntimeError):
            ref.topk_decode_ref(torch.as_tensor(vals), torch.as_tensor(idx), D)
    if name != "main-shape":  # the interpreted body folds all k per column block
        pallas = np.asarray(jkernels.topk_decode(jnp.asarray(vals), jnp.asarray(idx),
                                                 D, interpret=True, block_d=128))
        np.testing.assert_array_equal(got.numpy(), pallas)


def test_windowed_scatter_drops_negative_indices_as_the_pallas_body_does():
    """The kernel's window test drops a negative index, as the TPU body's
    compare never matches it; the reference's plain scatter wraps it
    (NumPy indexing), so the Pallas body is the oracle here."""
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((4, 6)).astype(np.float32)
    idx = np.stack([rng.permutation(19)[:6] for _ in range(4)]).astype(np.int32)
    idx[1, 3], idx[3, 0] = -1, -19
    got = emulate(torch.as_tensor(vals), torch.as_tensor(idx), 19, window=8)
    pallas = np.asarray(jkernels.topk_decode(jnp.asarray(vals), jnp.asarray(idx), 19,
                                             interpret=True, block_d=128))
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_windowed_scatter_k0_is_zeros():
    empty = torch.zeros(5, 0)
    want = torch.zeros(5, 11)
    for got in (emulate(empty, empty.to(torch.int32), 11),
                ref.topk_decode_ref(empty, empty.to(torch.int32), 11),
                codec.topk_decode(empty, empty.to(torch.int32), 11)):
        assert torch.equal(got, want)
    pallas = jkernels.topk_decode(jnp.zeros((5, 0)), jnp.zeros((5, 0), jnp.int32), 11,
                                  interpret=True)
    np.testing.assert_array_equal(np.asarray(pallas), want.numpy())


def _pallas_body_op_by_op(vals, idx, D):
    """``_topk_kernel``'s fold, ``acc + v_t * (i_t == cols)``, as its
    arithmetic reads, one eager jnp op at a time: no compiler sees the
    multiply beside the compare."""
    cols = jnp.arange(D, dtype=jnp.int32)[None, :]
    acc = jnp.zeros((vals.shape[0], D), jnp.float32)
    for t in range(vals.shape[1]):
        acc = acc + vals[:, t:t + 1] * (idx[:, t:t + 1] == cols).astype(jnp.float32)
    return np.asarray(acc)


def test_non_finite_values_stay_on_their_own_element():
    """A NaN and an inf land on their own element only, in the emulation
    and in both plain versions.  The Pallas body's arithmetic, acc + v *
    (i == col) over every column, gives NaN * 0 = NaN and inf * 0 = NaN on
    the rest of the row: pinned op by op as the reference kernel's
    divergence from its own plain version.  Under jit (interpret mode
    here), XLA rewrites the multiply by the converted compare into a
    select, and the body keeps them on their own element too.  Either way
    nothing downstream changes: the engine quarantines a row with any
    non-finite element (``core/engine.py``, the non-finite quarantine)."""
    rng = np.random.default_rng(5)
    N, k, D = 4, 6, 29
    vals = rng.standard_normal((N, k)).astype(np.float32)
    idx = np.stack([rng.permutation(D)[:k] for _ in range(N)]).astype(np.int32)
    vals[1, 2], vals[2, 4] = np.nan, np.inf
    got = emulate(torch.as_tensor(vals), torch.as_tensor(idx), D, window=12).numpy()
    want = np.asarray(jref.topk_decode_ref(jnp.asarray(vals), jnp.asarray(idx), D))
    np.testing.assert_array_equal(got, want)  # NaN where NaN, bit-equal elsewhere
    np.testing.assert_array_equal(
        got, ref.topk_decode_ref(torch.as_tensor(vals), torch.as_tensor(idx), D).numpy())
    assert np.isnan(got[1]).sum() == 1 and np.isnan(got[1, idx[1, 2]])
    assert np.isinf(got[2]).sum() == 1 and not np.isnan(got[2]).any()
    pallas = np.asarray(jkernels.topk_decode(jnp.asarray(vals), jnp.asarray(idx), D,
                                             interpret=True, block_d=128))
    np.testing.assert_array_equal(pallas, got)
    body = _pallas_body_op_by_op(jnp.asarray(vals), jnp.asarray(idx), D)
    assert np.isnan(body[1]).all()
    inf_col = idx[2, 4]
    assert np.isinf(body[2, inf_col]) and np.isnan(np.delete(body[2], inf_col)).all()
    for r in (0, 3):  # finite rows agree
        np.testing.assert_array_equal(body[r], got[r])


def test_each_bulk_copy_follows_the_fence_and_the_barrier():
    """The kernel's source orders a window's scatter, then every thread's
    ``fence.proxy.async.shared::cta``, then the barrier, then the bulk copy.
    Without the fence the copy (the async proxy) may read shared memory
    before the threads' writes are visible to it; on the H100 no card test
    has caught its absence.  The card test
    ``test_topk_decode_machine_code_fences_before_each_bulk_copy`` holds the
    built machine code to the same order; this holds the source."""
    src = (ops.CSRC / "compress.cu").read_text()
    body = src[src.index("topk_decode_kernel(const float*"):]
    body = body[:body.index("\n}\n")]
    scatter = body.index("scatter_row(")
    fence = body.index('"fence.proxy.async.shared::cta;')
    barrier = body.index("__syncthreads();", fence)
    copy = body.index("bulk_store(")
    assert scatter < fence < barrier < copy
    assert body.count("fence.proxy.async.shared::cta") == 1
    assert "tid == 0" not in body[fence - 80:fence]  # every thread fences
