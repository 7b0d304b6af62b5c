"""The port's CUDA kernels on the card (marked ``cuda``; skipped without a
GPU).  This file imports no JAX, so it runs on a GPU machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs;
the tolerances cover fp32 sums taken in another order.
"""
import dataclasses
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.fedar_mnist import fleet_fed, small_model
from repro_torch.core.fedar import FedARServer
from repro_torch.core.resources import TaskRequirement
from repro_torch.data.datasets import make_federated
from repro_torch.data.federated import table2_fleet
from repro_torch.kernels import ops, ref
from repro_torch.kernels.compress import pack_codes, topk_decode, unpack_codes
from repro_torch.kernels.defense_sim import sketch_similarity
from repro_torch.kernels.fedavg_agg import fedavg_agg
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.local_sgd import local_sgd, local_sgd_ragged
from repro_torch.kernels.ssm_scan import kernel_attrs, plan, ssm_scan
from repro_torch.models.model import Model

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, decided inside the test (never at import time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels build with nvcc at first use")
    return torch.device("cuda")


def _sgd_inputs(dev, I=16, H=8, C=10, R=4, n=37, seed=0):
    gen = torch.Generator().manual_seed(seed)
    D = H + C + I * H + H * C
    g = torch.randn(D, generator=gen) * 0.3
    x = torch.rand(R, n, I, generator=gen)
    y = torch.randint(0, C, (R, n), generator=gen, dtype=torch.int32)
    act = (torch.arange(R) % 2).to(torch.int32)  # mixed ReLU / softmax
    mask = torch.ones(R, n, dtype=torch.bool)
    mask[1, 25:] = False  # ragged client
    mask[2, :] = False  # all-False client
    mask[3, :20] = False  # one all-padding batch
    return tuple(t.to(dev) for t in (g, x, y, act, mask))


@pytest.mark.parametrize("I,H", [(16, 8), (784, 128), (784, 64)])
def test_local_sgd_kernel_matches_plain(cuda_device, I, H):
    g, x, y, act, mask = _sgd_inputs(cuda_device, I=I, H=H)
    kw = dict(hidden=H, classes=10, lr=0.1, batch_size=20, epochs=3)
    n0 = local_sgd.launches
    got = local_sgd(g, x, y, act, mask, **kw)
    assert local_sgd.launches == n0 + 1
    torch.testing.assert_close(got, ref.local_sgd_ref(g, x, y, act, mask, **kw),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got[2], g)  # all-False client: unchanged


def test_local_sgd_kernel_skips_dead_batches_between_live_ones(cuda_device):
    """Live batches around all-masked ones (the mask is read before the x
    tile, and a dead batch is neither loaded nor stepped), at the main
    path's width with mixed activations."""
    g, x, y, act, mask = _sgd_inputs(cuda_device, I=784, H=128, n=140)
    mask[:] = True
    mask[0, 20:60] = False   # batches 1 and 2 dead, 3.. live
    mask[1, 0:20] = False    # the first batch dead
    mask[1, 100:] = False    # the last two dead
    mask[3, 40:60] = False
    mask[3, 80:100] = False  # dead, live, dead, live
    kw = dict(hidden=128, classes=10, lr=0.1, batch_size=20, epochs=3)
    got = local_sgd(g, x, y, act, mask, **kw)
    torch.testing.assert_close(got, ref.local_sgd_ref(g, x, y, act, mask, **kw),
                               rtol=1e-5, atol=1e-5)


def test_local_sgd_kernel_long_chain(cuda_device):
    """A 350-step chain (5 epochs of 70 batches, phase 7's longest client)
    against the plain version; fp32 sums in another order over 350
    sequential steps, the tolerance chip_smoke.py holds the main path to."""
    g, x, y, act, mask = _sgd_inputs(cuda_device, I=784, H=128, n=1400)
    g = g / 6  # the 0.05 init scale of chip_smoke.py's main-path check
    mask[:] = True
    kw = dict(hidden=128, classes=10, lr=0.1, batch_size=20, epochs=5)
    got = local_sgd(g, x, y, act, mask, **kw)
    torch.testing.assert_close(got, ref.local_sgd_ref(g, x, y, act, mask, **kw),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("I,H", [(16, 8), (784, 128)])
def test_local_sgd_rows_do_not_depend_on_client_order(cuda_device, I, H):
    """The clients' rows given in reverse, so that the stable longest-first
    sort hands tied clients to other clusters, give bit-equal rows, in
    both forms."""
    from repro_torch.kernels.local_sgd import live_batches, longest_first

    g, x, y, act, mask = _sgd_inputs(cuda_device, I=I, H=H, R=6, n=57)
    mask[4, 40:] = False
    R = act.shape[0]
    fwd = longest_first(live_batches(mask, 20)).tolist()
    bwd = longest_first(live_batches(mask.flip(0), 20)).tolist()
    assert fwd != [R - 1 - c for c in bwd]  # the clusters train other clients
    kw = dict(hidden=H, classes=10, lr=0.1, epochs=2)
    base = local_sgd(g, x, y, act, mask, batch_size=20, **kw)
    back = local_sgd(g, x.flip(0), y.flip(0), act.flip(0), mask.flip(0),
                     batch_size=20, **kw).flip(0)
    assert torch.equal(back, base)
    xt, yt, mt, nb, off = _ragged_from_dense(x, y, mask, 20)
    ragged = local_sgd_ragged(g, xt, yt, mt, act, nb, off, **kw)
    assert torch.equal(ragged, base)
    back = local_sgd_ragged(g, xt, yt, mt, act.flip(0), nb.flip(0), off.flip(0),
                            **kw).flip(0)
    assert torch.equal(back, ragged)


def test_local_sgd_shape_that_fits_no_cluster_raises(cuda_device):
    """A batch of 80 rows of 784 (two x tiles of 251 KB) fits no cluster
    size; I = 18 is no whole number of 16-byte rows."""
    from repro_torch.kernels.local_sgd import plan

    assert plan(784, 128, 10, 20)[0] == 8
    g, x, y, act, mask = _sgd_inputs(cuda_device, I=784, H=128)
    with pytest.raises(ValueError, match="shared memory"):
        local_sgd(g, x, y, act, mask, hidden=128, classes=10, lr=0.1, batch_size=80,
                  epochs=1)
    g, x, y, act, mask = _sgd_inputs(cuda_device, I=18, H=8)
    with pytest.raises(ValueError, match="multiple of 4"):
        local_sgd(g, x, y, act, mask, hidden=8, classes=10, lr=0.1, batch_size=20,
                  epochs=1)


@pytest.mark.parametrize("hidden", [100, 256])
def test_engine_rejects_a_width_the_kernel_cannot_take(cuda_device, hidden):
    """A hidden width with no cluster plan (100: not 8 or 16 columns a
    CTA; 256: more than 8 CTAs) raises when the server is built on the
    kernel route, before any round; the plain route takes it."""
    with pytest.raises(ValueError, match="cannot take"):
        FedARServer(small_model(hidden), fleet_fed(12), TaskRequirement())
    FedARServer(small_model(hidden), fleet_fed(12, sgd_impl="einsum"), TaskRequirement())


def test_fedavg_agg_kernel_matches_plain(cuda_device):
    dev = cuda_device
    d, w = torch.randn(33, 1001, device=dev), torch.rand(33, device=dev)
    tau = torch.rand(33, device=dev) * 3
    for stale in (None, tau):
        torch.testing.assert_close(fedavg_agg(d, w, staleness=stale),
                                   ref.fedavg_agg_ref(d, w, stale),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,n,k", [
    (13, 29, 300), (12, 12, 20000), (40, 40, 256),
    (12, 12, 256), (512, 512, 256),  # foolsgold_sketch at 12 and 512 clients
    (12, 12, 101770),                # dense FoolsGold: split K, 8-byte copies
    (7, 9, 333),                     # odd K: 4-byte copies
])
def test_sketch_similarity_kernel_matches_plain(cuda_device, m, n, k):
    a = torch.randn(m, k, device=cuda_device)
    b = torch.randn(n, k, device=cuda_device)
    a, b = (t / torch.linalg.vector_norm(t, dim=1, keepdim=True) for t in (a, b))
    torch.testing.assert_close(sketch_similarity(a, b),
                               ref.sketch_similarity_ref(a, b),
                               rtol=1e-5, atol=1e-5)


def test_wrappers_validate_arguments(cuda_device):
    dev = cuda_device
    d = torch.randn(4, 10, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        fedavg_agg(d.double(), torch.rand(4, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        sketch_similarity(torch.randn(10, 4, device=dev).t(), d)
    g, x, y, act, mask = _sgd_inputs(dev)
    with pytest.raises(ValueError, match="dtype"):
        local_sgd(g, x, y.long(), act, mask, hidden=8, classes=10, lr=0.1,
                  batch_size=20, epochs=1)


@pytest.mark.parametrize("n,dim", [(5, 97), (12, 101770), (3, 1)])
def test_pack_unpack_kernels_match_plain(cuda_device, n, dim):
    """Integer codecs: bit-equal to the plain versions, odd D included."""
    gen = torch.Generator().manual_seed(dim)
    codes = torch.randint(0, 16, (n, dim), generator=gen, dtype=torch.int32)
    codes = codes.to(cuda_device)
    n0, u0 = pack_codes.launches, unpack_codes.launches
    packed = pack_codes(codes, bits=4)
    assert torch.equal(packed, ref.pack_codes_ref(codes, bits=4))
    back = unpack_codes(packed, bits=4, dim=dim)
    assert torch.equal(back, ref.unpack_codes_ref(packed, bits=4, dim=dim))
    assert torch.equal(back, codes)
    assert (pack_codes.launches, unpack_codes.launches) == (n0 + 1, u0 + 1)
    # 8 bits is a cast on both sides: no kernel
    assert torch.equal(unpack_codes(pack_codes(codes, bits=8), bits=8, dim=dim), codes)
    assert (pack_codes.launches, unpack_codes.launches) == (n0 + 1, u0 + 1)


def _distinct(gen, N, k, D):
    return torch.stack([torch.randperm(D, generator=gen)[:k] for _ in range(N)]).to(torch.int32)


def _poison(dev, numel):
    """Leave NaN in the block the caching allocator hands the next output of
    ``numel`` floats, so an element the kernel never writes shows."""
    torch.full((numel,), float("nan"), device=dev)


# (N, k, D): the main path's shapes at D = 101,770 (D * 4 is 8 mod 16:
# windows start mid-row, about one in twelve straddles two rows) and an odd
# D; a k that is not a multiple of 4 and an output whose last window ends in
# a partial 16-byte unit (33 * 101,771 = 3 mod 4); one window over every
# row, at D = 5, 10 and 13 (a remainder of 0, 2 and 1 floats); 32 windows of
# 128 rows each, with k = D (every element from an add) and k = 1
_TOPK_SHAPES = [(12, 3180, 101770), (512, 3180, 101770), (12, 3180, 101771),
                (512, 3180, 101771), (33, 3181, 101771), (64, 3, 5), (7, 4, 10),
                (9, 2, 13), (4096, 64, 64), (4096, 1, 64)]


def test_topk_decode_kernel_matches_plain(cuda_device):
    """Distinct indices (the path's case) and pairs of duplicates are exact
    at every shape of ``_TOPK_SHAPES``; triples may sum in another order,
    within a few ulp of the sum.  One launch a call; k = 0 launches
    nothing."""
    dev = cuda_device
    gen = torch.Generator().manual_seed(1)
    for N, k, D in _TOPK_SHAPES:
        vals = torch.randn(N, k, generator=gen).to(dev)
        idx = _distinct(gen, N, k, D).to(dev)
        pairs = torch.cat([idx[:, :k // 2], idx[:, :k - k // 2]], dim=1).contiguous()
        for name, ix in (("distinct", idx), ("pairs", pairs)):
            _poison(dev, N * D)
            n0 = topk_decode.launches
            got = topk_decode(vals, ix, D)
            assert topk_decode.launches == n0 + 1
            assert torch.equal(got, ref.topk_decode_ref(vals, ix, D)), (name, N, k, D)
    vals = torch.randn(12, 3180, generator=gen).to(dev)
    triples = torch.randint(0, 1000, (12, 3180), generator=gen, dtype=torch.int32).to(dev)
    torch.testing.assert_close(topk_decode(vals, triples, 101770),
                               ref.topk_decode_ref(vals, triples, 101770),
                               rtol=1e-5, atol=1e-5)
    n0 = topk_decode.launches
    empty = torch.empty(12, 0, device=dev)
    out = topk_decode(empty, empty.to(torch.int32), 101770)
    assert torch.equal(out, torch.zeros(12, 101770, device=dev))
    assert topk_decode.launches == n0


def test_topk_decode_kernel_drops_out_of_range_and_keeps_non_finite(cuda_device):
    """An index outside [0, D) is dropped; a NaN, an inf and a subnormal
    stay on their own element.  Held against the plain version on the CPU
    on the in-range pairs: the plain version raises on an index out of
    range, and on the card its scatter (global float atomics) flushes
    subnormals to zero, where the kernel's shared-memory adds keep them."""
    dev, D = cuda_device, 101771
    gen = torch.Generator().manual_seed(2)
    vals = torch.randn(12, 3180, generator=gen)
    idx = _distinct(gen, 12, 3180, D)
    idx[0, 5], idx[1, 7], idx[2, 9], idx[3, 0] = D, -1, D + 1000, 2**31 - 1
    vals[4, 3], vals[5, 4], vals[6, 6] = float("nan"), float("inf"), -float("inf")
    vals[7, 10], vals[7, 11] = 1e-40, -3e-42
    valid = (idx >= 0) & (idx < D)
    want = ref.topk_decode_ref(torch.where(valid, vals, 0.0), torch.where(valid, idx, 0), D)
    got = topk_decode(vals.to(dev), idx.to(dev), D).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert int(got[4].isnan().sum()) == 1 and int(got[5].isinf().sum()) == 1
    assert got[7, idx[7, 10]].item() == want[7, idx[7, 10]].item() != 0.0


@pytest.mark.parametrize("offsets", [(1, 1), (1, 2), (3, 0), (2, 2)])
def test_topk_decode_kernel_takes_unaligned_pairs(cuda_device, offsets):
    """vals and idx starting 4, 8 or 12 bytes past a 16-byte boundary, alike
    (a scalar head, then 16-byte groups) or not (every pair scalar)."""
    dev, N, k, D = cuda_device, 12, 3181, 101770
    gen = torch.Generator().manual_seed(3)
    v_base = torch.randn(N * k + 3, generator=gen).to(dev)
    i_base = torch.zeros(N * k + 3, dtype=torch.int32)
    ov, oi = offsets
    i_base[oi:oi + N * k] = _distinct(gen, N, k, D).flatten()
    v = v_base[ov:ov + N * k].view(N, k)
    i = i_base.to(dev)[oi:oi + N * k].view(N, k)
    assert torch.equal(topk_decode(v, i, D), ref.topk_decode_ref(v, i, D))


def test_topk_plan_is_one_wave_on_the_card(cuda_device):
    """The persistent grid of ``topk_plan`` fits the card at once: the
    occupancy API holds as many blocks an SM as the plan counts on."""
    from repro_torch.kernels.compress import topk_decode_attrs, topk_plan

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    p = topk_plan(512, 3180, 101770, sms=sms)
    attrs = topk_decode_attrs(p["smem_bytes"])
    assert p["blocks"] <= sms * attrs["blocks_per_sm"]


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_JUMPS = ("BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BREAK", "KILL")
_SHARED_WRITES = ("STS", "ATOMS", "LDGSTS", "STSM")


def _sass(text: str, kernel: str) -> list[tuple[int, bool, str, str]]:
    """(address, predicated, opcode, operands) of each instruction of
    ``kernel`` in ``cuobjdump -sass`` output."""
    funcs = [f for f in text.split("Function : ")[1:] if kernel in f.split("\n", 1)[0]]
    assert len(funcs) == 1, f"{kernel}: {len(funcs)} functions in the SASS"
    return [(int(a, 16), bool(pred), op, args)
            for a, pred, op, args in _SASS_LINE.findall(funcs[0])]


def check_fenced_bulk_copies(code) -> None:
    """Every thread executes a proxy fence (``FENCE.VIEW.ASYNC.S``) after
    its last shared-memory write and before the block barrier that precedes
    each bulk copy (``UBLKCP``).  The fence runs unpredicated, and from it
    to the barrier the code is straight-line (no jump out, no jump in), so
    every thread that reaches the barrier has fenced; from the barrier to
    the copy no shared memory is written and no jump enters from outside."""
    addrs = [a for a, *_ in code]
    jumps = [(a, int(t, 16)) for a, _p, op, args in code if op.startswith(_JUMPS)
             for t in re.findall(r"0x[0-9a-f]+", args)[:1]]
    copies = [i for i, (_a, _p, op, _x) in enumerate(code) if op.startswith("UBLKCP")]
    assert copies, "no bulk copy in the kernel"
    for c in copies:
        bars = [i for i in range(c) if code[i][2].startswith("BAR.SYNC")]
        assert bars, f"no barrier before the copy at {addrs[c]:#x}"
        bar = bars[-1]
        fences = [i for i in range(bar) if code[i][2] == "FENCE.VIEW.ASYNC.S"]
        assert fences, f"no proxy fence before the barrier at {addrs[bar]:#x}"
        f = fences[-1]
        assert not code[f][1], f"the fence at {addrs[f]:#x} is predicated"
        assert not any(op.startswith(_JUMPS + _SHARED_WRITES)
                       for _a, _p, op, _x in code[f:bar]), \
            f"a jump or a shared write between the fence at {addrs[f]:#x} and the barrier"
        assert not any(addrs[f] < t <= addrs[bar] for _a, t in jumps), \
            f"a jump lands between the fence at {addrs[f]:#x} and the barrier"
        assert not any(op.startswith(_SHARED_WRITES) for _a, _p, op, _x in code[bar:c]), \
            f"a shared write between the barrier and the copy at {addrs[c]:#x}"
        assert not any(addrs[bar] < t <= addrs[c] and not addrs[bar] < a < addrs[c]
                       for a, t in jumps), \
            f"a jump from outside lands between the barrier and the copy at {addrs[c]:#x}"


def test_topk_decode_machine_code_fences_before_each_bulk_copy(cuda_device):
    """The built kernel, not its source, orders each window's shared writes,
    every thread's proxy fence, the barrier and the bulk copy
    (``check_fenced_bulk_copies``).  A fence that is missing, compiled out,
    moved into a branch or put after the barrier fails here; at the test
    sizes the copies have read the right bytes without it."""
    tool = Path(ops._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", ops.library()._name], check=True,
                          capture_output=True, text=True).stdout
    check_fenced_bulk_copies(_sass(text, "topk_decode_kernel"))


@pytest.mark.parametrize("overrides", [
    dict(aggregation="async", compress="qsgd", compress_bits=4),
    dict(aggregation="fedar", compress="topk"),
], ids=["async-qsgd4", "fedar-topk"])
def test_compressed_rounds_on_the_card_match_plain_codecs(cuda_device, overrides):
    """Only ``compress_impl`` differs: the codec kernels are integer ops and
    a scatter of distinct indices, so every carried tensor is identical."""
    data = table2_fleet(samples_per_client=60)
    force = np.isin(np.arange(12), [2, 7])
    fed = fleet_fed(12, defense="none", **overrides)
    runs = []
    for impl in ("auto", "einsum"):
        server = FedARServer(small_model(32), dataclasses.replace(fed, compress_impl=impl),
                             TaskRequirement(), device=cuda_device)
        counts = [k.launches for k in (pack_codes, unpack_codes, topk_decode)]
        server.run(data, rounds=4, force_straggler=force)
        runs.append((server, [k.launches - c for k, c in zip(
            (pack_codes, unpack_codes, topk_decode), counts)]))
    (kern, launched), (plain, plain_launched) = runs
    assert plain_launched == [0, 0, 0]
    if overrides["compress"] == "qsgd":
        assert launched[0] > 0 and launched[1] > 0
    else:
        assert launched[2] > 0
    for name in ("params", "compress_residual", "pending_delta", "pending_weight",
                 "pending_valid", "fg_history"):
        assert torch.equal(getattr(kern.state, name), getattr(plain.state, name)), name
    assert torch.equal(kern.state.trust.score, plain.state.trust.score)


def test_round_on_the_card_matches_plain_route(cuda_device):
    """The engine on its default device (the card): every kernel launches,
    and the plain route gives the same trust and masks exactly and params
    within 2e-4."""
    data = table2_fleet(samples_per_client=60)
    fed = fleet_fed(12, defense="foolsgold_sketch")
    counts = [k.launches for k in (local_sgd, fedavg_agg, sketch_similarity)]
    server = FedARServer(small_model(32), fed, TaskRequirement())
    assert server.engine.device.type == "cuda"
    server.run(data, rounds=3)
    after = [k.launches for k in (local_sgd, fedavg_agg, sketch_similarity)]
    assert all(a > c for a, c in zip(after, counts))
    plain = FedARServer(small_model(32), dataclasses.replace(
        fed, sgd_impl="einsum", agg_impl="einsum", defense_impl="einsum"),
        TaskRequirement(), device=cuda_device)
    plain.run(data, rounds=3)
    for key in ("trust", "selected", "on_time"):
        np.testing.assert_array_equal(np.stack(server.history[key]),
                                      np.stack(plain.history[key]))
    torch.testing.assert_close(server.state.params, plain.state.params,
                               rtol=2e-4, atol=2e-4)


def _ragged_from_dense(x, y, mask, B):
    """Tile each client's first ``nb[r] = ceil(extent / B)`` batches of the
    dense rectangle into a ragged buffer, one client after another."""
    R, n = mask.shape
    last = torch.where(mask.any(1),
                       n - torch.flip(mask, [1]).to(torch.int8).argmax(1), 1)
    nb = ((last + B - 1) // B).to(torch.int32)
    nb_pad = -(-n // B)
    xp = torch.nn.functional.pad(x, (0, 0, 0, nb_pad * B - n)).view(R, nb_pad, B, -1)
    yp = torch.nn.functional.pad(y, (0, nb_pad * B - n)).view(R, nb_pad, B)
    mp = torch.nn.functional.pad(mask, (0, nb_pad * B - n)).view(R, nb_pad, B)
    keep = torch.arange(nb_pad, device=x.device)[None, :] < nb[:, None]
    off = (torch.cumsum(nb, 0) - nb).to(torch.int32)
    return (xp[keep].contiguous(), yp[keep].contiguous(), mp[keep].contiguous(),
            nb, off)


@pytest.mark.parametrize("I,H", [(16, 8), (784, 128), (784, 64)])
def test_local_sgd_ragged_kernel_matches_plain_and_dense(cuda_device, I, H):
    """The ragged kernel against its plain version (fp32 sums in another
    order), and bit-equal to the dense kernel on the same clients: one
    template, the same batches, masked samples add exact zeros."""
    g, x, y, act, mask = _sgd_inputs(cuda_device, I=I, H=H, n=57)
    xt, yt, mt, nb, off = _ragged_from_dense(x, y, mask, 20)
    kw = dict(hidden=H, classes=10, lr=0.1, epochs=3)
    n0 = local_sgd_ragged.launches
    got = local_sgd_ragged(g, xt, yt, mt, act, nb, off, **kw)
    assert local_sgd_ragged.launches == n0 + 1
    torch.testing.assert_close(
        got, ref.local_sgd_ragged_ref(g, xt, yt, mt, act, nb, off, **kw),
        rtol=1e-5, atol=1e-5)
    assert torch.equal(got, local_sgd(g, x, y, act, mask, batch_size=20, **kw))
    assert torch.equal(got[2], g)  # all-False client: unchanged
    empty = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    out = local_sgd_ragged(g, xt, yt, mt, empty, empty, empty, **kw)
    assert out.shape == (0, g.shape[0])
    assert local_sgd_ragged.launches == n0 + 1  # R = 0 launches nothing
    with pytest.raises(ValueError, match="outside"):
        local_sgd_ragged(g, xt, yt, mt, act, nb, off + 1, **kw)


@pytest.mark.parametrize("select_frac", [None, 0.5])
def test_packed_rounds_on_the_card_match_plain_route(cuda_device, select_frac):
    """The packed layout on the card runs the ragged kernel and never the
    dense one; the plain route gives the same trust and masks exactly and
    params within 2e-4."""
    ds = make_federated("digits", 16, scenario="quantity_skew",
                        samples_per_client=60, seed=7)
    fed = fleet_fed(16, defense="foolsgold_sketch", select_frac=select_frac)
    server = FedARServer(small_model(32), fed, TaskRequirement())
    data = server.engine.prepare_data(ds, layout="packed")
    counts = [k.launches for k in (local_sgd, local_sgd_ragged)]
    server.run(data, rounds=3)
    assert local_sgd.launches == counts[0]
    assert local_sgd_ragged.launches == counts[1] + 3
    plain = FedARServer(small_model(32), dataclasses.replace(
        fed, sgd_impl="einsum", agg_impl="einsum", defense_impl="einsum"),
        TaskRequirement(), device=cuda_device)
    plain.run(data, rounds=3)
    for key in ("trust", "selected", "on_time"):
        np.testing.assert_array_equal(np.stack(server.history[key]),
                                      np.stack(plain.history[key]))
    torch.testing.assert_close(server.state.params, plain.state.params,
                               rtol=2e-4, atol=2e-4)


# bf16 outputs: the kernel and the plain version each round an fp32 result
# to bf16 (8 bits of mantissa), so an element may differ by an ulp of
# itself; and the attention kernel rounds P to bf16 before P V, an error of
# a fraction of its row's values that shows on outputs near zero.  So each
# row (one head of one position) is held to its own largest value.
BF16_RTOL = 1.6e-2


def _close(got, want, rtol):
    """Row by row, the last axis a row (one head of one position): every
    element within ``rtol * max|want|`` over its own row."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = rtol * want.abs().amax(dim=-1, keepdim=True)
    worst = (err / limit.clamp_min(1e-30)).max().item()
    assert bool((err <= limit).all()), (
        f"max_abs_err {err.max().item():.3e}, largest error / tolerance {worst:.3f}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,S,H,K,hd,window,causal", [
    (2, 200, 4, 2, 112, 0, True),    # ragged S, GQA, zamba2's head_dim
    (1, 256, 4, 4, 64, 48, True),    # sliding window
    (1, 130, 2, 1, 128, 0, True),    # one kv head, the largest head_dim
    (1, 96, 2, 2, 32, 0, False),     # no causal mask
])
def test_flash_attention_kernel_matches_plain(cuda_device, dtype, B, S, H, K, hd,
                                              window, causal):
    """fp32: sums and exponentials in another order (rtol = 1e-4); bf16: an
    ulp of the output and P in bf16 (``_close``)."""
    gen = torch.Generator().manual_seed(S + hd)
    q, k, v = (torch.randn(B, S, n, hd, generator=gen).to(cuda_device, dtype)
               for n in (H, K, K))
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    _close(got, want, 1e-4 if dtype == torch.float32 else BF16_RTOL)


@pytest.mark.parametrize("hd", [32, 64, 112, 128])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 200, 2048])
def test_flash_attention_bf16_tensor_cores_over_s_and_head_dim(cuda_device, S, hd):
    """The bf16 instance (wgmma on TMA tiles): S on both sides of the 64-row
    warpgroup and 128-row block edges, where the causal mask meets the
    accumulator's fragment layout, and head dims that pad to 64 or 128."""
    gen = torch.Generator().manual_seed(S * 131 + hd)
    q, k, v = (torch.randn(1, S, 2, hd, generator=gen).to(cuda_device, torch.bfloat16)
               for _ in range(3))
    got = flash_attention(q, k, v, causal=True)
    _close(got, ref.flash_attention_ref(q, k, v, causal=True), BF16_RTOL)


@pytest.mark.parametrize("B,S,H,K,hd,window,causal", [
    (2, 300, 16, 2, 64, 0, True),     # GQA, G = 8
    (1, 1000, 8, 1, 112, 0, True),    # GQA, G = 8, zamba2's head_dim
    (1, 700, 4, 4, 64, 48, True),     # window shorter than a key tile
    (2, 1500, 4, 2, 112, 512, True),  # window over several key tiles
    (1, 333, 4, 4, 128, 0, False),    # no causal mask, ragged S
    (1, 200, 4, 2, 40, 48, False),    # window without the causal mask
])
def test_flash_attention_bf16_gqa_window_and_full(cuda_device, B, S, H, K, hd, window,
                                                  causal):
    gen = torch.Generator().manual_seed(S + H)
    q, k, v = (torch.randn(B, S, n, hd, generator=gen).to(cuda_device, torch.bfloat16)
               for n in (H, K, K))
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    _close(got, want, BF16_RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,S,nh,hd,st", [(2, 200, 8, 64, 64), (1, 128, 4, 32, 16)])
def test_ssm_scan_kernel_matches_plain(cuda_device, dtype, B, S, nh, hd, st):
    """Against the sequential recurrence: fp32 sums in another order over S
    steps (rtol = 1e-4, ``_close``); bf16: an ulp of the output."""
    gen = torch.Generator().manual_seed(S + st)
    xd = (torch.randn(B, S, nh, hd, generator=gen) * 0.5).to(cuda_device, dtype)
    logdecay = (-torch.rand(B, S, nh, generator=gen) * 0.5).to(cuda_device)
    Bc, Cc = (torch.randn(B, S, st, generator=gen).to(cuda_device, dtype) for _ in "BC")
    n0 = ssm_scan.launches
    got = ssm_scan(xd, logdecay, Bc, Cc)
    assert ssm_scan.launches == n0 + 1
    assert got.dtype == dtype and got.shape == xd.shape
    want = ref.ssm_scan_ref(xd, logdecay, Bc, Cc).to(dtype)
    _close(got, want, 1e-4 if dtype == torch.float32 else BF16_RTOL)


def _model_scan_inputs(dev, B, S, nh, hd, st, seed):
    """As the model makes them: dt = softplus(.), A = -linspace(1, 16, nh),
    x scaled by dt."""
    gen = torch.Generator().manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn(B, S, nh, generator=gen))
    logdecay = dt * -torch.linspace(1.0, 16.0, nh)
    xd = torch.randn(B, S, nh, hd, generator=gen) * dt[..., None]
    Bc, Cc = (torch.randn(B, S, st, generator=gen) for _ in "BC")
    return tuple(t.to(dev) for t in (xd, logdecay, Bc, Cc))


# the fp32 scan against the float64 recurrence: each row within this many
# times the fp32 plain version's largest error relative to its row (its
# chunked decays are differences of cumsums, so its rounding follows the
# chunk's decay history, not the row; chip_smoke.compare_scan_fp32)
FP32_SCAN_FACTOR = 4


def _close_to_fp64(got, plain, want64):
    row_max = want64.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
    rel = ((plain.double() - want64).abs().amax(dim=-1, keepdim=True) / row_max).max()
    err = (got.double() - want64).abs()
    limit = FP32_SCAN_FACTOR * rel * row_max
    assert bool((err <= limit).all()), (
        f"largest error / tolerance {(err / limit).max().item():.3f} "
        f"(the plain version's relative error {rel.item():.3e})")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,S,nh,hd,st", [
    (1, 200, 4, 64, 32),    # ragged S, st != hd
    (2, 1000, 3, 32, 48),   # ragged S over 16 chunks
    (1, 4096, 2, 64, 64),   # B = 1, 64 chunks
    (1, 333, 5, 16, 24),    # hd 16: one slice, half of it past hd
    (2, 130, 2, 48, 16),    # hd 48: the second 32-column slice is half full
])
def test_ssm_scan_over_shapes_at_the_model_decay_range(cuda_device, B, S, nh, hd, st,
                                                       dtype):
    """The model's own decays (log-decays down to ~-11 a step).  bf16: row
    by row at ``BF16_RTOL`` against the sequential recurrence; fp32 (the
    FMA instance): against the float64 recurrence."""
    xd, logdecay, Bc, Cc = _model_scan_inputs(cuda_device, B, S, nh, hd, st, S + hd)
    xd, Bc, Cc = (t.to(dtype) for t in (xd, Bc, Cc))
    n0 = ssm_scan.launches
    got = ssm_scan(xd, logdecay, Bc, Cc)
    assert ssm_scan.launches == n0 + 1
    assert got.dtype == dtype and got.shape == xd.shape
    plain = ref.ssm_scan_ref(xd, logdecay, Bc, Cc)
    if dtype == torch.bfloat16:
        _close(got, plain.to(dtype), BF16_RTOL)
    else:
        _close_to_fp64(got, plain,
                       ref.ssm_scan_ref(xd, logdecay, Bc, Cc, dtype=torch.float64))


@pytest.mark.parametrize("seed", [0, 28])
def test_ssm_scan_bf16_keeps_the_state_near_fp32(cuda_device, seed):
    """S = 2,048, 32 heads of 64, state 64, the model's decays, from numpy
    seeds on which the emulation in tests/test_torch_ssm_scan.py misses
    BF16_RTOL when the state (both seeds) or B_j exp(lc_L - lc_j) (seed 28)
    enters its product as one bf16 value: the kernel's hi + lo pairs hold."""
    B, S, nh, hd, st = 1, 2048, 32, 64, 64
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh))))
    logdecay = torch.as_tensor((dt * -np.linspace(1.0, 16.0, nh)).astype(np.float32))
    xd = torch.as_tensor((rng.standard_normal((B, S, nh, hd)) * dt[..., None])
                         .astype(np.float32))
    Bc, Cc = (torch.as_tensor(rng.standard_normal((B, S, st)).astype(np.float32))
              for _ in "BC")
    xd, Bc, Cc = (t.to(cuda_device, torch.bfloat16) for t in (xd, Bc, Cc))
    logdecay = logdecay.to(cuda_device)
    got = ssm_scan(xd, logdecay, Bc, Cc)
    _close(got, ref.ssm_scan_ref(xd, logdecay, Bc, Cc).to(torch.bfloat16), BF16_RTOL)


def test_ssm_scan_bf16_refuses_what_it_cannot_copy(cuda_device):
    """hd and st multiples of 8 (16-byte rows) and 16-byte aligned
    storage: anything else raises before a launch."""
    dev = cuda_device
    n0 = ssm_scan.launches
    ld = torch.zeros(1, 8, 2, device=dev)
    bc = torch.randn(1, 8, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        ssm_scan(torch.randn(1, 8, 2, 20, device=dev, dtype=torch.bfloat16), ld, bc, bc)
    xd = torch.randn(1, 8, 2, 16, device=dev, dtype=torch.bfloat16)
    odd = torch.randn(1, 8, 12, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        ssm_scan(xd, ld, odd, odd)
    shifted = torch.randn(xd.numel() + 1, device=dev, dtype=torch.bfloat16)[1:].view(xd.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        ssm_scan(shifted, ld, bc, bc)
    assert ssm_scan.launches == n0
    # the fp32 instance takes those shapes
    x32 = torch.randn(1, 8, 2, 20, device=dev)
    b32 = torch.randn(1, 8, 12, device=dev)
    got = ssm_scan(x32, ld, b32, b32)
    _close(got, ref.ssm_scan_ref(x32, ld, b32, b32), 1e-4)


def test_ssm_scan_resources_match_the_plan(cuda_device):
    a = kernel_attrs()
    assert a["smem_bytes"] == plan(1, 64, 1, 64, 64)["smem_bytes"]
    assert a["local_bytes"] == 0 and 0 < a["registers"] <= 128
    assert a["blocks_per_sm"] == 4


def test_lm_kernel_wrappers_validate_arguments(cuda_device):
    dev = cuda_device
    q = torch.randn(1, 8, 2, 129, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    q = torch.randn(1, 8, 2, 100, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):  # bf16: TMA's 16-byte strides
        flash_attention(q, q, q)
    q = torch.randn(1, 8, 3, 16, device=dev)
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    xd = torch.randn(1, 8, 2, 16, device=dev)
    Bc = torch.randn(1, 8, 4, device=dev)
    with pytest.raises(ValueError, match="logdecay"):
        ssm_scan(xd, torch.zeros(1, 8, 2, device=dev, dtype=torch.bfloat16), Bc, Bc)
    with pytest.raises(ValueError, match="state"):
        ssm_scan(xd, torch.zeros(1, 8, 2, device=dev), torch.randn(1, 8, 65, device=dev),
                 torch.randn(1, 8, 65, device=dev))


def _check_blocks(cfg, params, tokens):
    """Each block application of the prefill, from the plain route's input
    to it: the kernel route's increment to the residual within atol = rtol
    = 1e-4 of its row's largest plain increment (a row is one position of
    one sequence), and the logits from the last block's two outputs within
    1e-4 (``chip_smoke.check_blocks``' bound, row by row)."""
    from repro_torch.models import blocks
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import layer_windows

    with torch.inference_mode():
        x = torch.nn.functional.embedding(tokens.long(), params["embed"])
        pos = torch.arange(x.shape[1], device=x.device)
        if "shared_attn" in params:
            apps = []
            for i, lp in enumerate(params["layers"]):
                apps.append(lambda x, impl, lp=lp: blocks.mamba_block_forward(lp, x, cfg, impl))
                if (i + 1) % cfg.shared_attn_every == 0:
                    apps.append(lambda x, impl: blocks.attn_block_forward(
                        params["shared_attn"], x, pos, cfg, cfg.sliding_window, impl))
        else:
            apps = [lambda x, impl, lp=lp, w=w: blocks.attn_block_forward(lp, x, pos, cfg, w, impl)
                    for lp, w in zip(params["layers"], layer_windows(cfg).tolist())]
        for n, app in enumerate(apps):
            got, want = app(x, "kernel") - x, app(x, "einsum") - x
            limit = 1e-4 + 1e-4 * want.abs().amax(dim=-1, keepdim=True)
            worst = ((got - want).abs() / limit).max().item()
            assert worst <= 1.0, f"block {n}: largest error / tolerance {worst:.3f}"
            last = x + got
            x = x + want
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = [rms_norm(h[:, -1], params["final_norm"], cfg.norm_eps) @ head
                  for h in (last, x)]
    torch.testing.assert_close(logits[0], logits[1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,layers,launches", [
    ("zamba2-7b", 4, (2, 4)), ("tinyllama-1.1b", 2, (2, 0)),
])
def test_lm_prefill_on_the_card_matches_plain_route(cuda_device, arch, layers, launches):
    """``Model`` on its default device runs kernels 8 and 9 once per
    attention and Mamba2 layer, and each block application agrees with the
    plain route (``attn_impl = ssm_impl = "einsum"``) from the same input
    (``_check_blocks``), over four seeds of params and tokens, each drawn
    from a seeded ``torch.Generator``.  The free-running trunk is not held
    to 1e-4: four random-init layers amplify rounding (ROADMAP Trap 3)."""
    cfg = get_config(arch).reduced(num_layers=layers)
    model = Model(cfg)
    assert model.device.type == "cuda"
    for seed in range(4):
        gen = torch.Generator(device=cuda_device).manual_seed(seed)
        params = model.init_params(gen)
        tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, device=cuda_device)
        counts = (flash_attention.launches, ssm_scan.launches)
        got = model.prefill(params, {"tokens": tokens})
        assert (flash_attention.launches - counts[0],
                ssm_scan.launches - counts[1]) == launches
        assert got.shape == (2, cfg.vocab_size) and torch.isfinite(got).all()
        _check_blocks(cfg, params, tokens)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch,over", [
    ("zamba2-7b", {}), ("tinyllama-1.1b", {}), ("tinyllama-1.1b", dict(sliding_window=8)),
], ids=["zamba2-7b", "tinyllama-1.1b", "tinyllama-ring8"])
def test_lm_decode_on_the_card_matches_the_cpu(cuda_device, arch, over):
    """fp32 decode from the same params (drawn on a seeded CPU generator):
    16 prompt tokens then 8 of the CPU's greedy tokens, both devices fed
    the same token; logits within 1e-4 at every step, the caches after the
    last, and no launch of kernel 8 or 9 (decode is plain PyTorch)."""
    cfg = get_config(arch).reduced(**over)
    card, cpu = Model(cfg), Model(cfg, device="cpu")
    params = card.init_params(torch.Generator().manual_seed(0))
    params_cpu = cpu.init_params(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)))
    cache, cache_cpu = card.init_cache(2, 24), cpu.init_cache(2, 24)
    counts = (flash_attention.launches, ssm_scan.launches)
    tok = toks[:, :1]
    for t in range(24):
        logits, cache = card.decode_step(params, cache, tok.to(cuda_device), t)
        want, cache_cpu = cpu.decode_step(params_cpu, cache_cpu, tok, t)
        torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)
        tok = toks[:, t + 1:t + 2] if t + 1 < 16 else want.argmax(-1, keepdim=True)
    assert (flash_attention.launches, ssm_scan.launches) == counts
    for got, want in zip(_leaves(cache), _leaves(cache_cpu)):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_lm_kernels_refuse_inputs_that_require_grad(cuda_device):
    """Kernels 8 and 9 have no backward (ROADMAP Trap 5): an input that
    requires grad raises instead of giving an output without a gradient."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(1, 64, 4, 64, device=cuda_device, generator=gen, dtype=torch.bfloat16)
    k = torch.randn(1, 64, 2, 64, device=cuda_device, generator=gen, dtype=torch.bfloat16)
    for i in range(3):
        ins = [t.clone() for t in (q, k, k)]
        ins[i].requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention(*ins)
    xd = torch.randn(1, 64, 4, 32, device=cuda_device, generator=gen)
    ld = -torch.rand(1, 64, 4, device=cuda_device, generator=gen)
    Bc = torch.randn(1, 64, 16, device=cuda_device, generator=gen)
    for i in range(4):
        ins = [t.clone() for t in (xd, ld, Bc, Bc)]
        ins[i].requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            ssm_scan(*ins)
    # without grad both still launch
    flash_attention(q, k, k)
    ssm_scan(xd, ld, Bc, Bc)


def test_lm_client_update_on_the_card_matches_the_cpu(cuda_device):
    """One reduced LM client block (two clients, E = 2, a ragged sample
    mask) trained on the card and on the CPU from the same params: the
    flat rows within 2e-4; the card's engine takes the plain
    client_update under sgd_impl="auto" and refuses "kernel"."""
    from repro_torch.core.engine import FedAREngine, flatten, ordered_leaves, with_leaves
    from repro_torch.models.model import LMClientModel

    cfg = get_config("tinyllama-1.1b").reduced(num_layers=2, d_model=64, d_ff=128,
                                               vocab_size=128, num_heads=4, num_kv_heads=2)
    cpu = LMClientModel(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(4)
    tok = torch.as_tensor(rng.integers(0, 128, (2, 10, 16)))
    lab = torch.as_tensor(rng.integers(0, 128, (2, 10, 16)))
    mask = torch.ones(2, 10, dtype=torch.bool)
    mask[1, 7:] = False
    kw = dict(lr=0.05, batch_size=4, epochs=2)
    want = cpu.client_update(params, {"tokens": tok, "labels": lab}, sample_mask=mask, **kw)
    card = LMClientModel(cfg, device=cuda_device)
    on_card = {"tokens": tok.to(cuda_device), "labels": lab.to(cuda_device)}
    params_card = with_leaves(params, [t.to(cuda_device) for _, t in ordered_leaves(params)])
    got = card.client_update(params_card, on_card, sample_mask=mask.to(cuda_device), **kw)
    assert got.device.type == "cuda" and got.shape == want.shape
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-4, atol=2e-4)
    assert (got.cpu() != flatten(params)).any()
    engine = FedAREngine(card, fleet_fed(4, defense="foolsgold_sketch"), TaskRequirement(),
                         device=cuda_device)
    assert engine.sgd_route == "einsum"
    with pytest.raises(ValueError, match="has none"):
        FedAREngine(card, fleet_fed(4, sgd_impl="kernel"), TaskRequirement(),
                    device=cuda_device)


@pytest.mark.parametrize("n,D", [(12, 101_770), (256, 101_770), (4, 5_000_003), (3, 2048)])
def test_count_sketch_is_bit_equal_run_to_run(cuda_device, n, D):
    """The count sketch kernel against the float64 sums within 1e-6 +
    1e-5 of the largest output (its plain version, the reference's fp32
    scatter-add, rounds about as far off at D = 5e6), NaN where the plain
    version has it, and bit-equal over ten runs on the same rows; one
    launch a call."""
    from repro_torch.common.config import FedConfig
    from repro_torch.core.defense import SketchedFoolsGold
    from repro_torch.kernels.count_sketch import count_sketch, count_sketch_ref

    sk = SketchedFoolsGold(FedConfig(defense="foolsgold_sketch", seed=n), D, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(D)
    rows = torch.randn(n, D, device=cuda_device, generator=gen) * 0.01
    rows[0, 5] = float("nan")  # stays on its own row
    want = count_sketch_ref(rows, sk.bucket, sk.sign, sk.r)
    before = count_sketch.launches
    runs = [sk.sketch(rows) for _ in range(10)]
    assert count_sketch.launches == before + 10
    assert all(torch.equal(r[1:], runs[0][1:]) for r in runs)
    assert torch.isnan(runs[0][0]).sum() == 1 and torch.isfinite(runs[0][1:]).all()
    exact = torch.zeros(n, sk.r, dtype=torch.float64, device=cuda_device).index_add_(
        1, sk.bucket, rows.double() * sk.sign.double())
    err = (runs[0][1:].double() - exact[1:]).abs().max().item()
    assert err <= 1e-6 + 1e-5 * exact[1:].abs().max().item()
    assert torch.equal(torch.isnan(runs[0]), torch.isnan(want))
