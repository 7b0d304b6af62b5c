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
from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM, flash_attention, fp32_attrs,
                                                  fp32_plan, tensor_core_attrs)
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


@pytest.mark.parametrize("I,H", [(16, 8), (784, 128), (784, 512), (13, 128), (784, 813)])
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


def test_local_sgd_shapes_that_once_fit_no_cluster_run_and_match_plain(cuda_device):
    """The two shapes that once fit no cluster -- a batch of 80 rows of 784
    (two x tiles of 251 KB) and I = 18 (no whole number of 16-byte rows) --
    now run, the first on the tiled plan, the second on the general
    instance, and match the plain version, the ragged form bit-equal to the
    dense; and the server builds on the kernel route at the paper's B = 40
    (the third point of its Fig. 6 grid)."""
    from repro_torch.common.config import FedConfig
    from repro_torch.configs.fedar_mnist import MnistConfig
    from repro_torch.kernels.local_sgd import plan

    assert plan(784, 128, 10, 20)[:2] == (8, 16)
    for I, H, B, inst in ((784, 128, 80, "tiled"), (18, 8, 20, "general")):
        p = plan(I, H, 10, B)
        assert p.instance == inst and p.streamed == (inst == "general")
        g, x, y, act, mask = _sgd_inputs(cuda_device, I=I, H=H, n=97)
        g = g / 6
        kw = dict(hidden=H, classes=10, lr=0.1, epochs=2)
        n0 = local_sgd.launches
        got = local_sgd(g, x, y, act, mask, batch_size=B, **kw)
        assert local_sgd.launches == n0 + 1
        torch.testing.assert_close(got, ref.local_sgd_ref(g, x, y, act, mask, batch_size=B,
                                                          **kw), rtol=1e-5, atol=1e-5)
        assert torch.equal(got[2], g)
        xt, yt, mt, nb, off = _ragged_from_dense(x, y, mask, B)
        assert torch.equal(local_sgd_ragged(g, xt, yt, mt, act, nb, off, **kw), got)
    server = FedARServer(MnistConfig(), FedConfig(local_batch_size=40), TaskRequirement())
    assert server.engine.sgd_route == "kernel"


@pytest.mark.parametrize("hidden", [1025, 1536])
def test_widths_past_the_wide_instance_run_on_the_general_instance(cuda_device, hidden):
    """Hidden widths past the wide instance's 1,024: at I = 16 (inside the
    reference's envelope) the direct call runs on the general instance and
    matches the plain version; the server at I = 784 (past the envelope,
    which ends at H = 873 for B = 20: the reference falls back to XLA there)
    builds on the kernel route too, since the general plan takes it."""
    from repro_torch.kernels.local_sgd import fused_fits_vmem, plan

    assert fused_fits_vmem(20, 16, hidden, 10) and not fused_fits_vmem(20, 784, hidden, 10)
    assert plan(784, hidden, 10, 20).instance == "general"
    server = FedARServer(small_model(hidden), fleet_fed(12), TaskRequirement())
    assert server.engine.sgd_route == "kernel"
    g, x, y, act, mask = _sgd_inputs(cuda_device, I=16, H=hidden)
    kw = dict(hidden=hidden, classes=10, lr=0.1, batch_size=20, epochs=2)
    n0 = local_sgd.launches
    got = local_sgd(g, x, y, act, mask, **kw)
    assert local_sgd.launches == n0 + 1
    torch.testing.assert_close(got, ref.local_sgd_ref(g, x, y, act, mask, **kw),
                               rtol=1e-5, atol=1e-5)
    FedARServer(small_model(hidden), fleet_fed(12, sgd_impl="einsum"), TaskRequirement())


# The reference's envelope's corners (fused_fits_vmem(B, I, H, C) at its
# largest B, C and H): the batch at 784 / 128 / 10, the class count at 784 /
# 128 with B = 20, the hidden width at I = 16, B = 20.
ENVELOPE_CORNERS = [(784, 128, 10, 2279), (784, 128, 4611, 20), (16, 26209, 10, 20)]


def test_plan_takes_every_shape_of_the_reference_envelope(cuda_device):
    """A seeded grid of (I, H, C, B) inside ``fused_fits_vmem`` (4,000
    log-uniform draws of I 1-1,024, H 1-30,000, C 1-1,000, B 1-600, of which
    3,286 lie inside, and the corners): ``plan`` takes every
    one, from the shapes alone (plan only, no launch), and the narrow and
    wide plans keep every shape they took before the general instance."""
    from repro_torch.kernels.local_sgd import fused_fits_vmem, plan

    rng = np.random.default_rng(30)

    def draw(hi):  # log-uniform on [1, hi]: small and large widths alike
        return np.exp(rng.uniform(0.0, np.log(hi), 4000)).astype(np.int64).clip(1, hi)

    draws = zip(draw(1024), draw(30000), draw(1000), draw(600))
    shapes = [tuple(int(v) for v in d) for d in draws if fused_fits_vmem(d[3], d[0], d[1], d[2])]
    assert len(shapes) > 3000
    for I, H, C, B in ENVELOPE_CORNERS:
        assert fused_fits_vmem(B, I, H, C)
    assert not fused_fits_vmem(2280, 784, 128, 10)
    assert not fused_fits_vmem(20, 784, 128, 4612) and not fused_fits_vmem(20, 16, 26210, 10)
    seen = set()
    for I, H, C, B in shapes + ENVELOPE_CORNERS:
        p = plan(I, H, C, B)
        assert p.cluster >= 1 and p.cluster * p.slice >= H, (I, H, C, B)
        seen.add(p.instance)
        if p.instance == "general":
            assert 1 <= p.rows <= min(B, 64) and p.workspace > 0
        if p.instance == "tiled":
            assert 5 <= p.rows <= 20 and p.rows < B and p.workspace == 0 and H <= 256
    assert seen == {"narrow", "wide", "general", "tiled"}
    assert plan(784, 128, 10, 20).instance == "narrow"
    assert plan(784, 512, 10, 20).instance == "wide"


def test_shape_past_the_plan_raises_before_any_launch(cuda_device):
    """What no instance takes: a dimension under 1, or a workspace slot past
    2^31 floats (I = H = 50,000, far past the envelope); the direct call
    raises before any launch."""
    from repro_torch.kernels.local_sgd import plan

    with pytest.raises(ValueError, match="cannot take I=50000"):
        plan(50000, 50000, 10, 20)
    g, x, y, act, mask = _sgd_inputs(cuda_device, I=16, H=8)
    n0 = local_sgd.launches
    with pytest.raises(ValueError, match="dimension is under 1"):
        local_sgd(g[:8 + 16 * 8], x, y, act, mask, hidden=8, classes=0, lr=0.1,
                  batch_size=20, epochs=1)
    assert local_sgd.launches == n0


@pytest.mark.parametrize("I,H,C,B", [(784, 128, 10, 40), (784, 128, 10, 50),
                                     (784, 128, 47, 20), (784, 128, 100, 20),
                                     (13, 128, 10, 20), (30, 128, 10, 20),
                                     (16, 4096, 10, 20), (784, 512, 10, 40),
                                     (784, 128, 10, 200)])
def test_local_sgd_general_instance_matches_plain(cuda_device, I, H, C, B):
    """Phase 2's ``GENERAL_SHAPES``: the general instance at class counts
    past 16, I not a multiple of 4, H past 1,024 and B = 40 past H = 256,
    and the tiled plan at the batches past 20 at MNIST width: both
    activations, a ragged tail, an all-False client, labels over all C
    classes, against the plain version; the ragged form bit-equal to the
    dense; at least one cluster resident, no spills."""
    from repro_torch.kernels.local_sgd import kernel_attrs

    a = kernel_attrs(I, H, C, B)
    want = "tiled" if (I, H, C) == (784, 128, 10) else "general"
    assert a["instance"] == want and a["max_clusters"] >= 1 and a["local_bytes"] == 0
    g, x, y, act, mask = _sgd_inputs(cuda_device, I=I, H=H, C=C, R=6, n=2 * B + 17)
    g = g / 6
    kw = dict(hidden=H, classes=C, lr=0.1, epochs=2)
    got = local_sgd(g, x, y, act, mask, batch_size=B, **kw)
    torch.testing.assert_close(got, ref.local_sgd_ref(g, x, y, act, mask, batch_size=B, **kw),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got[2], g)
    xt, yt, mt, nb, off = _ragged_from_dense(x, y, mask, B)
    assert torch.equal(local_sgd_ragged(g, xt, yt, mt, act, nb, off, **kw), got)



# The tiled plan's shapes: the paper's MLP at B = 21 (sub-tiles of 20 and
# 1), 40 (Fig. 6), 50 (20, 20, 10) and 200 (ten of 20), and B = 40 at H =
# 100 (7 x 16 padded) and 256 (16 x 16, a non-portable cluster)
TILED_SHAPES = [(128, 21), (128, 40), (128, 50), (128, 200), (100, 40), (256, 40)]


@pytest.mark.parametrize("H,B", TILED_SHAPES)
def test_local_sgd_tiled_plan_matches_plain(cuda_device, H, B):
    """Kernels 1 and 4 on the tiled plan: the narrow plan's cluster and
    slices at B = 20, no workspace, no spills, a cluster resident; both
    activations, a ragged tail, an all-masked batch and an all-False client
    against the plain version (fp32 sums in another order); the ragged form
    bit-equal to the dense, and both bit-equal again with the clients
    given in reverse (other clusters train them)."""
    from repro_torch.kernels.local_sgd import kernel_attrs, plan

    a = kernel_attrs(784, H, 10, B)
    assert a["instance"] == "tiled" and a["rows"] == 20 and a["workspace"] == 0
    assert (a["cluster"], a["slice"]) == tuple(plan(784, H, 10, 20)[:2])
    assert not a["streamed"] and a["local_bytes"] == 0 and a["max_clusters"] >= 1
    g, x, y, act, mask = _sgd_inputs(cuda_device, I=784, H=H, R=6, n=2 * B + 17)
    mask[3, B:2 * B] = False  # an all-masked batch between live ones
    g = g / 6
    kw = dict(hidden=H, classes=10, lr=0.1, epochs=2)
    n0 = local_sgd.launches
    got = local_sgd(g, x, y, act, mask, batch_size=B, **kw)
    assert local_sgd.launches == n0 + 1
    torch.testing.assert_close(got, ref.local_sgd_ref(g, x, y, act, mask, batch_size=B, **kw),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got[2], g)
    xt, yt, mt, nb, off = _ragged_from_dense(x, y, mask, B)
    assert torch.equal(local_sgd_ragged(g, xt, yt, mt, act, nb, off, **kw), got)
    back = local_sgd(g, x.flip(0), y.flip(0), act.flip(0), mask.flip(0), batch_size=B,
                     **kw).flip(0)
    assert torch.equal(back, got)
    back = local_sgd_ragged(g, xt, yt, mt, act.flip(0), nb.flip(0), off.flip(0),
                            **kw).flip(0)
    assert torch.equal(back, got)


def test_plan_routes_batches_past_20_to_the_tiled_plan(cuda_device):
    """``plan`` from the shapes alone: the paper's MLP on the tiled plan at
    every B from 21 to 200 (K = 8 x 16 columns, sub-tiles of 20 rows, no
    workspace), on the narrow plan at B <= 20 as before, the wide instance
    at H = 512, B = 20 (8 x 64 columns since its redesign); C = 47, I = 18
    and H = 4,096 at B = 40 stay on the general instance."""
    from repro_torch.kernels.local_sgd import plan

    for B in range(21, 201):
        p = plan(784, 128, 10, B)
        assert (p.instance, p.cluster, p.slice, p.rows, p.workspace, p.streamed) == (
            "tiled", 8, 16, 20, 0, False), B
    for B in range(1, 21):
        p = plan(784, 128, 10, B)
        assert (p.instance, p.cluster, p.slice, p.rows, p.workspace) == (
            "narrow", 8, 16, B, 0), B
    p = plan(784, 512, 10, 20)
    assert (p.instance, p.cluster, p.slice, p.streamed) == ("wide", 8, 64, True)
    for I, H, C in ((784, 128, 47), (18, 8, 10), (16, 4096, 10)):
        assert plan(I, H, C, 40).instance == "general", (I, H, C)

# Digests of kernel 1's and 4's output bits (the first 16 hex digits of
# SHA-256) at the widths the unpadded plan takes (at most 8 slices of 8 or
# 16 columns), on scripts/local_sgd_widths.py's inputs (I = 784, R = 12,
# n = 200, E = 5), as the kernel wrote them before H could be padded, on an
# NVIDIA H100 80GB HBM3 (CUDA 12.8, torch 2.11): the padded plan leaves
# those widths bit for bit as they were.
UNPADDED_PLAN_DIGESTS = {8: "5d1e3ad28c80c62a", 16: "09c3518f4284ecf5", 32: "bf83501bb2441c89",
                     64: "fb9b4cdb12359b0f", 128: "7172f3ee2a6f51d1"}


# The same digests at the widths the narrow plan pads (H = 100 to 7 x 16,
# 200 to 13 x 16, 256 as 16 x 16), as the kernel wrote them before H could
# pass 256, on an NVIDIA H100 80GB HBM3 (CUDA 12.8, torch 2.11): the wide
# instance leaves the narrow plan bit for bit as it was.
PADDED_PLAN_DIGESTS = {100: "edfe7272867f1fa2", 200: "149278d0755be822",
                       256: "6b4422a4ca450622"}


def _widths_script():
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "scripts" / "local_sgd_widths.py"
    spec = importlib.util.spec_from_file_location("local_sgd_widths", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _width_digests(dev, H):
    """The digests of both forms' output bits on the widths script's inputs
    (I = 784, R = 12, n = 200, E = 5)."""
    w = _widths_script()
    g, x, y, act, mask = (torch.as_tensor(a, device=dev) for a in w.inputs(H, 12, 200))
    kw = dict(hidden=H, classes=10, lr=0.1, epochs=5)
    dense = local_sgd(g, x, y, act, mask, batch_size=20, **kw)
    xt, yt, mt, nb, off = (torch.as_tensor(a, device=dev) for a in
                           w.ragged(x.cpu().numpy(), y.cpu().numpy(), mask.cpu().numpy(), 20))
    rag = local_sgd_ragged(g, xt, yt, mt, act, nb, off, **kw)
    return w.digest(dense), w.digest(rag)


@pytest.mark.parametrize("H", sorted(UNPADDED_PLAN_DIGESTS))
def test_local_sgd_bit_equal_to_the_unpadded_plan(cuda_device, H):
    from repro_torch.kernels.local_sgd import plan

    assert _width_digests(cuda_device, H) == (UNPADDED_PLAN_DIGESTS[H],) * 2
    K, HS = plan(784, H, 10, 20)[:2]
    assert K * HS == H and K <= 8


@pytest.mark.parametrize("H", sorted(PADDED_PLAN_DIGESTS))
def test_local_sgd_bit_equal_to_the_padded_plan(cuda_device, H):
    from repro_torch.kernels.local_sgd import plan

    assert _width_digests(cuda_device, H) == (PADDED_PLAN_DIGESTS[H],) * 2
    p = plan(784, H, 10, 20)
    assert p.slice == 16 and p.cluster * p.slice >= H and not p.streamed
    assert p.instance == "narrow"


def _close_or_plain_kink(got, want, want64, tol=1e-5):
    """Kernel rows within ``tol`` (atol = rtol) of the fp32 plain version's;
    a row that is not must be the plain version's kink: its fp32 plain row
    is over ``tol`` from the plain version run in float64 (``want64()``; a
    ReLU pre-activation within rounding of 0 took the other branch there)
    and the kernel's row is within ``tol`` of that float64 row."""
    close = ((got - want).abs() <= tol + tol * want.abs()).all(1)
    if bool(close.all()):
        return
    rows = torch.nonzero(~close).flatten()
    truth = want64()[rows]
    plain_off = ((want[rows].double() - truth).abs() > tol + tol * truth.abs()).any(1)
    assert bool(plain_off.all()), f"rows {rows.tolist()}: the kernel, not the plain version"
    torch.testing.assert_close(got[rows].double(), truth, rtol=tol, atol=tol)


@pytest.mark.parametrize("H,K,HS,B", [(100, 7, 16, 20), (200, 13, 16, 20), (256, 16, 16, 20),
                                      (257, 5, 64, 20), (512, 8, 64, 20), (640, 5, 128, 20),
                                      (813, 7, 128, 20), (879, 7, 128, 20), (1024, 8, 128, 20),
                                      (512, 8, 64, 1), (813, 7, 128, 7), (512, 8, 64, 13)])
def test_local_sgd_kernel_at_wide_hidden_matches_plain(cuda_device, H, K, HS, B):
    """H padded to K slices of HS columns (K > 8: a non-portable cluster;
    past H = 256 the wide instance, w1 streamed from L2 through a ring):
    both activations, a ragged tail, an all-masked batch and an all-False
    client against the plain version; the ragged form bit-equal to the
    dense; at least one cluster resident, no spills."""
    from repro_torch.kernels.local_sgd import kernel_attrs

    a = kernel_attrs(784, H, 10, B)
    assert (a["cluster"], a["slice"], a["streamed"]) == (K, HS, H > 256)
    assert a["instance"] == ("wide" if H > 256 else "narrow")
    assert a["max_clusters"] >= 1
    assert a["dynamic_smem"] <= ops.MAX_SMEM_BYTES and a["local_bytes"] == 0
    g, x, y, act, mask = _sgd_inputs(cuda_device, I=784, H=H, R=6, n=57)
    g = g / 6
    kw = dict(hidden=H, classes=10, lr=0.1, epochs=3)
    got = local_sgd(g, x, y, act, mask, batch_size=B, **kw)
    _close_or_plain_kink(got, ref.local_sgd_ref(g, x, y, act, mask, batch_size=B, **kw),
                         lambda: ref.local_sgd_ref(g.double(), x.double(), y, act, mask,
                                                   batch_size=B, dtype=torch.float64, **kw))
    assert torch.equal(got[2], g)
    xt, yt, mt, nb, off = _ragged_from_dense(x, y, mask, B)
    assert torch.equal(local_sgd_ragged(g, xt, yt, mt, act, nb, off, **kw), got)


def test_plan_takes_every_wide_width_at_mnist_input(cuda_device):
    """``plan(784, H, 10, B)`` names the wide instance for every H from 257
    to 1,024 and every B from 1 to 20 (K <= 8 slices of 64 or 128 columns,
    a ring of at least three slots), no spilled bytes, at least one cluster
    resident; H > 256 at B > 20 stays on the general instance."""
    from repro_torch.kernels.local_sgd import kernel_attrs, plan

    for H in range(257, 1025):
        for B in range(1, 21):
            p = plan(784, H, 10, B)
            assert (p.instance, p.streamed, p.rows) == ("wide", True, B), (H, B)
            assert p.cluster <= 8 and p.slice in (64, 128) and p.ring >= 3, (H, B)
            assert (p.cluster - 1) * p.slice < H <= p.cluster * p.slice, (H, B)
            assert p.smem_bytes <= ops.MAX_SMEM_BYTES, (H, B)
        assert plan(784, H, 10, 21).instance == "general", H
    for H in (257, 512, 640, 813, 879, 1024):
        a = kernel_attrs(784, H, 10, 20)
        assert a["local_bytes"] == 0 and a["max_clusters"] >= 1, H


@pytest.mark.parametrize("layout", ["dense", "packed", "gated"])
@pytest.mark.parametrize("hidden", [100, 256, 257, 512, 813, 879, 1024])
def test_wide_hidden_rounds_on_the_kernel_route_match_einsum(cuda_device, hidden, layout):
    """``small_model(hidden)`` through the engine on the default route
    (``sgd_impl="auto"``, which resolves to the kernel on the card), dense,
    packed and gated packed (half the fleet selected), against
    ``sgd_impl="einsum"``: one launch a round, trust and masks identical,
    params within 2e-4."""
    ds = make_federated("digits", 16, scenario="quantity_skew", samples_per_client=60,
                        seed=7)
    fed = fleet_fed(16, defense="foolsgold_sketch",
                    **(dict(select_frac=0.5) if layout == "gated" else {}))
    kern = local_sgd if layout == "dense" else local_sgd_ragged
    n0 = kern.launches
    server = FedARServer(small_model(hidden), fed, TaskRequirement())
    assert server.engine.sgd_route == "kernel"
    data = server.engine.prepare_data(ds, layout="dense" if layout == "dense" else "packed")
    server.run(data, rounds=3)
    assert kern.launches == n0 + 3
    plain = FedARServer(small_model(hidden), dataclasses.replace(fed, sgd_impl="einsum"),
                        TaskRequirement())
    plain.run(data, rounds=3)
    for key in ("trust", "selected", "on_time"):
        np.testing.assert_array_equal(np.stack(server.history[key]),
                                      np.stack(plain.history[key]))
    torch.testing.assert_close(server.state.params, plain.state.params,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("layout", ["dense", "packed", "gated"])
@pytest.mark.parametrize("B", [40, 60])
def test_general_instance_rounds_on_the_kernel_route_match_einsum(cuda_device, B, layout):
    """The paper's MLP (784 -> 128 -> 10) at batches the narrow plan cannot
    hold (the tiled plan's), through the engine on the default route,
    dense, packed and gated packed (half the fleet selected), against
    ``sgd_impl="einsum"``: one launch a round, trust and masks identical,
    params within 2e-4."""
    from repro_torch.configs.fedar_mnist import MnistConfig
    from repro_torch.kernels.local_sgd import plan

    assert plan(784, 128, 10, B).instance == "tiled"
    ds = make_federated("digits", 16, scenario="quantity_skew", samples_per_client=3 * B,
                        seed=7)
    fed = fleet_fed(16, defense="foolsgold_sketch", local_batch_size=B,
                    **(dict(select_frac=0.5) if layout == "gated" else {}))
    kern = local_sgd if layout == "dense" else local_sgd_ragged
    n0 = kern.launches
    server = FedARServer(MnistConfig(), fed, TaskRequirement())
    assert server.engine.sgd_route == "kernel"
    data = server.engine.prepare_data(ds, layout="dense" if layout == "dense" else "packed")
    server.run(data, rounds=3)
    assert kern.launches == n0 + 3
    plain = FedARServer(MnistConfig(), dataclasses.replace(fed, sgd_impl="einsum"),
                        TaskRequirement())
    plain.run(data, rounds=3)
    for key in ("trust", "selected", "on_time"):
        np.testing.assert_array_equal(np.stack(server.history[key]),
                                      np.stack(plain.history[key]))
    torch.testing.assert_close(server.state.params, plain.state.params,
                               rtol=2e-4, atol=2e-4)


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
@pytest.mark.parametrize("B,S,H,K,hd,window,causal", [
    (1, 1000, 4, 1, 256, 512, True),  # gemma3-1b's local layer, ragged S, one kv head
    (2, 333, 4, 1, 256, 0, True),     # its global layer
    (1, 200, 2, 2, 256, 48, False),   # window without the causal mask
    (1, 129, 2, 1, 200, 0, True),     # a head_dim that pads to 256
    (1, 129, 2, 1, 136, 0, True),     # its last 64-column box wholly past hd
    (1, 64, 4, 2, 256, 0, True),      # one 64-key tile
])
def test_flash_attention_kernel_at_head_dim_256(cuda_device, dtype, B, S, H, K, hd,
                                                window, causal):
    """The instances that pad hd to 256 (bf16: 64-key tiles, P V in two
    m64n128 halves; fp32: 16 output columns a thread) against the plain
    version, with the tolerances of ``test_flash_attention_kernel_matches_plain``."""
    gen = torch.Generator().manual_seed(S * 7 + hd)
    q, k, v = (torch.randn(B, S, n, hd, generator=gen).to(cuda_device, dtype)
               for n in (H, K, K))
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == n0 + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    _close(got, want, 1e-4 if dtype == torch.float32 else BF16_RTOL)


@pytest.mark.parametrize("hdp", [64, 128, 256])
def test_flash_attention_bf16_instances_spill_nothing(cuda_device, hdp):
    """Each bf16 instance keeps its accumulators in registers (0 local
    bytes) and its tiles within the shared memory a block may take."""
    a = tensor_core_attrs(hdp)
    assert a["local_bytes"] == 0, a
    assert a["static_smem"] + a["dynamic_smem"] <= ops.MAX_SMEM_BYTES, a


def _fp32_qkv(dev, B, S, H, K, hd, seed, v_mean=0.0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, S, n, hd, generator=gen) for n in (H, K, K))
    return q.to(dev), k.to(dev), (v + v_mean).to(dev)


@pytest.mark.parametrize("hd", [1, 3, 61, 64, 96, 100, 112, 128, 200, 256])
@pytest.mark.parametrize("window", [0, 100])
def test_flash_attention_fp32_over_head_dims(cuda_device, hd, window):
    """The fp32 instances at every kind of head dim: 16-byte copies (hd %
    4 == 0) and 4-byte ones (1, 3, 61), all three instances (hd <= 64, <=
    128 and above), a ragged S and a GQA group of 2; rtol 1e-4 row by row,
    one launch counted a call.  v has mean 2: at hd 1 or 3 a row of zero-mean
    v is a weighted mean of a few values that can cancel to ~1e-4, where
    fp32's rounding of the terms (~1e-7, in both versions) would pass a
    tolerance relative to the row; with the mean no row nears 0, and a
    wrong weight still moves it by ~p times v's spread of 1."""
    q, k, v = _fp32_qkv(cuda_device, 2, 333, 4, 2, hd, seed=hd + window, v_mean=2.0)
    assert fp32_plan(2, 333, 4, 2, hd, window).copy_bytes == (16 if hd % 4 == 0 else 4)
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=window)
    assert flash_attention.launches == n0 + 1
    _close(got, ref.flash_attention_ref(q, k, v, causal=True, window=window), 1e-4)


@pytest.mark.parametrize("B,S,H,K,hd,window,causal", [
    (1, 1000, 4, 4, 64, 0, True),     # group of 1, ragged S
    (2, 517, 16, 4, 112, 64, True),   # group of 4, a window of one key tile
    (1, 700, 14, 2, 64, 0, True),     # group of 7 (internvl2-1b's)
    (1, 1030, 8, 1, 128, 300, True),  # group of 8, a window across tiles
    (2, 129, 8, 1, 256, 0, False),    # no causal mask, the 256 instance
    (1, 200, 7, 7, 96, 48, False),    # a window without the causal mask
    (3, 65, 2, 1, 40, 0, True),       # S one past a key tile
])
def test_flash_attention_fp32_gqa_windows_and_ragged_s(cuda_device, B, S, H, K, hd,
                                                       window, causal):
    q, k, v = _fp32_qkv(cuda_device, B, S, H, K, hd, seed=S + H)
    got = flash_attention(q, k, v, causal=causal, window=window)
    _close(got, ref.flash_attention_ref(q, k, v, causal=causal, window=window), 1e-4)


@pytest.mark.parametrize("parts", [None, 1, 3, 16])
def test_flash_attention_fp32_split_on_and_off(cuda_device, parts):
    """gemma3-1b's route-check layer (1 x 1,024, 4 heads of 256 over one
    kv head) with the plan's split (it engages here), none, and forced
    splits (16 leaves parts with no key tile, and with the window rows
    with no live key in a part); each within 1e-4 of the plain version,
    with one launch counted for the two kernels."""
    q, k, v = _fp32_qkv(cuda_device, 1, 1024, 4, 1, 256, seed=5)
    assert fp32_plan(1, 1024, 4, 1, 256).parts > 1
    for window in (0, 512, 100):
        n0 = flash_attention.launches
        got = flash_attention(q, k, v, causal=True, window=window, parts=parts)
        assert flash_attention.launches == n0 + 1
        assert torch.isfinite(got).all()
        _close(got, ref.flash_attention_ref(q, k, v, causal=True, window=window), 1e-4)


@pytest.mark.parametrize("shape", [(1, 1024, 4, 1, 256, 512), (2, 700, 8, 2, 112, 0),
                                   (1, 300, 4, 4, 61, 0)])
def test_flash_attention_fp32_is_bit_equal_run_to_run(cuda_device, shape):
    """Two launches on the same input give the same bits, with the split
    (the first shape) and without."""
    B, S, H, K, hd, window = shape
    q, k, v = _fp32_qkv(cuda_device, B, S, H, K, hd, seed=7)
    a = flash_attention(q, k, v, causal=True, window=window)
    b = flash_attention(q, k, v, causal=True, window=window)
    assert torch.equal(a, b)


def test_flash_attention_fp32_takes_unaligned_storage(cuda_device):
    """Contiguous tensors 4 bytes past a 16-byte boundary take the 4-byte
    copies at an hd that is a multiple of 4."""
    B, S, H, hd = 1, 300, 4, 64
    gen = torch.Generator().manual_seed(11)
    flat = [torch.randn(B * S * H * hd + 1, generator=gen).to(cuda_device) for _ in range(3)]
    q, k, v = (f[1:].view(B, S, H, hd) for f in flat)
    assert q.data_ptr() % 16 and q.is_contiguous()
    got = flash_attention(q, k, v, causal=True)
    _close(got, ref.flash_attention_ref(q, k, v, causal=True), 1e-4)


def test_flash_attention_fp32_instances_spill_nothing(cuda_device):
    """Every fp32 instance (each with 16- and 4-byte copies) and the merge
    kernel keep everything in registers (0 local bytes), and the shared
    bytes the build reports at an hd are the plan's, within what a block
    may take."""
    for hd in (1, 61, 64, 112, 128, 200, 256):
        attrs = fp32_attrs(hd)
        for name, a in attrs.items():
            assert a["local_bytes"] == 0, (name, a)
        p = fp32_plan(1, 1024, 4, 1, hd)
        a = attrs[f"{p.instance}, {p.copy_bytes}-byte copies"]
        assert a["dynamic_smem"] == p.smem_bytes, a
        assert a["static_smem"] + a["dynamic_smem"] <= ops.MAX_SMEM_BYTES, a


def test_gemma3_shape_at_head_dim_256_launches_the_kernel_once_a_layer(cuda_device):
    """Two gemma3-1b layers at its head_dim of 256 (one kv head, the local
    window) under ``attn_impl="auto"``: one launch a layer, and each block
    within 1e-4 of the plain route in fp32 (``_check_blocks``)."""
    cfg = dataclasses.replace(get_config("gemma3-1b").reduced(), head_dim=256)
    model = Model(cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = model.init_params(gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=gen, device=cuda_device)
    n0 = flash_attention.launches
    got = model.prefill(params, {"tokens": tokens})
    assert flash_attention.launches - n0 == cfg.num_layers
    assert got.shape == (2, cfg.vocab_size) and torch.isfinite(got).all()
    _check_blocks(cfg, params, tokens)


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
    q = torch.randn(1, 8, 2, MAX_HEAD_DIM + 8, device=dev)  # 264
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q.to(torch.bfloat16), q.to(torch.bfloat16), q.to(torch.bfloat16))
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


def _check_blocks(cfg, params, tokens, x=None):
    """Each block application of the prefill, from the plain route's input
    to it: the kernel route's increment to the residual within atol = rtol
    = 1e-4 of its row's largest plain increment (a row is one position of
    one sequence), and the logits from the last block's two outputs within
    1e-4 (``chip_smoke.check_blocks``' bound, row by row).  ``x``: the
    embedded request, when the tokens' embeddings are not all of it (the
    vision stub's patches come first)."""
    from repro_torch.models import blocks
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import layer_windows

    with torch.inference_mode():
        if x is None:
            x = torch.nn.functional.embedding(tokens.long(), params["embed"])
        pos = torch.arange(x.shape[1], device=x.device)
        if "shared_attn" in params:
            apps = []
            for i, lp in enumerate(params["layers"]):
                apps.append(lambda x, impl, lp=lp: blocks.mamba_block_forward(lp, x, cfg, impl))
                if (i + 1) % cfg.shared_attn_every == 0:
                    apps.append(lambda x, impl: blocks.attn_block_forward(
                        params["shared_attn"], x, pos, cfg, cfg.sliding_window, impl)[0])
        else:
            apps = [lambda x, impl, lp=lp, w=w: blocks.attn_block_forward(
                lp, x, pos, cfg, w, impl)[0]
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
    ("qwen2-moe-a2.7b", 2, (2, 0)), ("minicpm3-4b", 2, (2, 0)), ("arctic-480b", 2, (2, 0)),
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


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-medium"])
def test_frontend_prefill_on_the_card_matches_plain_route(cuda_device, arch):
    """The two stub frontends at ``reduced()`` (internvl2-1b with its 16
    patch positions ahead of 48 text tokens): kernel 8 once a layer, each
    block on the kernel route against the plain route from the same input
    (``_check_blocks``), over two seeds."""
    from repro_torch.models.model import VISION_STUB_DIM

    cfg = get_config(arch).reduced()
    model = Model(cfg)
    for seed in range(2):
        gen = torch.Generator(device=cuda_device).manual_seed(seed)
        params = model.init_params(gen)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 48), generator=gen,
                                         device=cuda_device)}
        if cfg.frontend == "vision_stub":
            batch["patches"] = torch.randn(2, cfg.num_patches, VISION_STUB_DIM, generator=gen,
                                           device=cuda_device)
        n0 = flash_attention.launches
        got = model.prefill(params, batch)
        assert flash_attention.launches - n0 == cfg.num_layers
        assert got.shape == (2, cfg.vocab_size) and torch.isfinite(got).all()
        x, offset = model.embed(params, batch)
        assert offset == (cfg.num_patches if cfg.frontend == "vision_stub" else 0)
        _check_blocks(cfg, params, batch["tokens"], x)


def test_xlstm_pair_on_the_card_matches_the_cpu(cuda_device):
    """One reduced xLSTM pair in fp32 from the same params (drawn on a
    seeded CPU generator): its prefill over 2 x 256 positions (two mLSTM
    chunks) and 32 decode steps on the card against the CPU within 1e-4 of
    each row's largest value, the caches after the last step too, and no
    kernel launched (the xLSTM has none)."""
    from repro_torch.models import blocks

    cfg = get_config("xlstm-350m").reduced()
    params = blocks.init_xlstm_pair(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    card = {k: (v.to(cuda_device) if torch.is_tensor(v) else
                {kk: vv.to(cuda_device) for kk, vv in v.items()}) for k, v in params.items()}
    x = torch.randn(2, 256, cfg.d_model, generator=torch.Generator().manual_seed(1))
    counts = (flash_attention.launches, ssm_scan.launches)
    with torch.inference_mode():
        got = blocks.xlstm_pair_forward(card, x.to(cuda_device), cfg)
        want = blocks.xlstm_pair_forward(params, x, cfg)
        _close(got.cpu() - x, want - x, 1e-4)
        cache = blocks.init_xlstm_pair_cache(cfg, 2, cuda_device)
        cache_cpu = blocks.init_xlstm_pair_cache(cfg, 2, "cpu")
        for t in range(32):
            step, _ = blocks.xlstm_pair_decode(card, cache, x[:, t:t + 1].to(cuda_device), cfg)
            step_cpu, _ = blocks.xlstm_pair_decode(params, cache_cpu, x[:, t:t + 1], cfg)
            _close(step.cpu() - x[:, t:t + 1], step_cpu - x[:, t:t + 1], 1e-4)
    assert (flash_attention.launches, ssm_scan.launches) == counts
    for got_c, want_c in zip(_leaves(cache), _leaves(cache_cpu)):
        torch.testing.assert_close(got_c.cpu(), want_c, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("H,K", [(14, 2), (24, 24)], ids=["internvl2-14over2", "musicgen-24"])
def test_flash_attention_at_the_frontend_configs_heads(cuda_device, dtype, H, K):
    """Kernel 8 at internvl2-1b's 14 heads over 2 (a GQA group of 7) and
    musicgen-medium's 24 of 64, on a ragged S, against the plain version."""
    gen = torch.Generator().manual_seed(H * 100 + K)
    q = torch.randn(2, 1030, H, 64, generator=gen).to(cuda_device, dtype)
    k, v = (torch.randn(2, 1030, K, 64, generator=gen).to(cuda_device, dtype) for _ in "kv")
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == n0 + 1 and got.shape == q.shape
    _close(got, ref.flash_attention_ref(q, k, v, causal=True),
           1e-4 if dtype == torch.float32 else BF16_RTOL)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch,over", [
    ("zamba2-7b", {}), ("tinyllama-1.1b", {}), ("tinyllama-1.1b", dict(sliding_window=8)),
    ("qwen2-moe-a2.7b", {}), ("minicpm3-4b", {}), ("minicpm3-4b", dict(sliding_window=8)),
], ids=["zamba2-7b", "tinyllama-1.1b", "tinyllama-ring8", "qwen2-moe", "minicpm3",
        "minicpm3-ring8"])
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


@pytest.mark.parametrize("dispatch", ["onehot", "scatter"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "arctic-480b"])
def test_moe_on_the_card_matches_the_cpu(cuda_device, arch, dispatch):
    """The MoE sub-layer (reduced, fp32, capacity factor 0.5 so that tokens
    drop, 1,200 tokens so that the second group is padded) on the card
    against the CPU from the same params and input: a token whose kept
    experts differ must sit within 1e-5 of a tie and is left out; every
    other token within 1e-4, and the aux loss."""
    from repro_torch.models import moe

    cfg = get_config(arch).reduced(moe_capacity_factor=0.5, moe_dispatch=dispatch)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x = torch.randn(3, 400, cfg.d_model, generator=torch.Generator().manual_seed(1))
    card = {k: (v.to(cuda_device) if torch.is_tensor(v) else
                {kk: vv.to(cuda_device) for kk, vv in v.items()}) for k, v in params.items()}
    got, aux = moe.moe_forward(card, x.to(cuda_device), cfg)
    want, aux_cpu = moe.moe_forward(params, x, cfg)
    torch.testing.assert_close(aux.cpu(), aux_cpu, rtol=1e-4, atol=1e-4)
    on_card, _ = moe.kept_experts(card, x.to(cuda_device), cfg)
    on_cpu, margin = moe.kept_experts(params, x, cfg)
    differ = (on_card.cpu() != on_cpu).any(-1)
    assert (margin[differ] < 1e-5).all()
    same = (~differ).reshape(x.shape[:2])
    torch.testing.assert_close(got.cpu()[same], want[same], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("over", [{}, dict(qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
                                           num_heads=40, num_kv_heads=40)],
                         ids=["reduced", "hd96-40heads"])
def test_mla_prefill_kernel_route_matches_plain_route(cuda_device, over):
    """``mla_forward`` on the card in fp32: the kernel route (kernel 8 on v
    padded to q's head dim, one launch) against the plain route on the same
    params and input, at the reduced widths and at minicpm3-4b's head dims
    (96 for q and k, 64 for v) and 40 heads, within 1e-4 of each row's
    largest value.  (bf16 at these head dims: the next test.)"""
    dtype = torch.float32
    from repro_torch.models import attention

    cfg = get_config("minicpm3-4b").reduced(**over)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = attention.init_mla(gen, cfg, dtype, cuda_device)
    x = torch.randn(2, 300, cfg.d_model, generator=gen, device=cuda_device).to(dtype)
    pos = torch.arange(300, device=cuda_device)
    for window in (0, 64):
        n0 = flash_attention.launches
        got = attention.mla_forward(params, x, pos, cfg, window, "kernel")
        assert flash_attention.launches == n0 + 1
        want = attention.mla_forward(params, x, pos, cfg, window, "einsum")
        _close(got, want, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,S", [(1, 300), (2, 1030)])
def test_flash_attention_at_mla_head_dims(cuda_device, dtype, B, S):
    """Kernel 8 at minicpm3-4b's (., 40, 96) with v's 64 columns padded with
    zeros to 96: the padded output columns exactly 0, the rest the plain
    version's on the unpadded v."""
    gen = torch.Generator().manual_seed(S)
    q, k = (torch.randn(B, S, 40, 96, generator=gen).to(cuda_device, dtype) for _ in range(2))
    v = torch.randn(B, S, 40, 64, generator=gen).to(cuda_device, dtype)
    got = flash_attention(q, k, torch.nn.functional.pad(v, (0, 32)), causal=True)
    assert torch.equal(got[..., 64:], torch.zeros_like(got[..., 64:]))
    want = ref.flash_attention_ref(q, k, torch.nn.functional.pad(v, (0, 32)), causal=True)
    _close(got[..., :64].contiguous(), want[..., :64].contiguous(),
           1e-4 if dtype == torch.float32 else BF16_RTOL)


def test_mla_kernel_route_refuses_inputs_that_require_grad(cuda_device):
    """ROADMAP Trap 5 through MLA's padded call: params that require grad
    make kernel 8 raise on the kernel route; the plain route differentiates."""
    from repro_torch.models import attention

    cfg = get_config("minicpm3-4b").reduced()
    params = attention.init_mla(torch.Generator(device=cuda_device).manual_seed(0), cfg,
                                torch.float32, cuda_device)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    x = torch.randn(1, 64, cfg.d_model, device=cuda_device)
    pos = torch.arange(64, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.mla_forward(params, x, pos, cfg, 0, "kernel")
    attention.mla_forward(params, x, pos, cfg, 0, "einsum").sum().backward()
    assert params["wv_b"].grad is not None


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


# ---------------------------------------------------------------------------
# fleets drawn from IDX files (ArraySource) through the engine on the card
# ---------------------------------------------------------------------------

def _replayed_draws(rounds, n, device):
    """The same Gumbel draws and latency factors for a card run and a CPU
    run (the engine's own generators differ between the two devices)."""
    from repro_torch.convert import ReplayDraws
    from repro_torch.core.resources import LATENCY_JITTER

    rng = np.random.default_rng(11)
    gumbel = rng.gumbel(size=(rounds, n))
    latency = np.exp(LATENCY_JITTER * rng.standard_normal((rounds, n)))
    return ReplayDraws(gumbel, latency, device=device)


@pytest.mark.parametrize("fleet", ["emnist-quantity-skew", "sybil-mnist"])
def test_idx_fleets_on_the_card_match_the_cpu(cuda_device, tmp_path, fleet):
    """A fleet drawn from IDX files (``ArraySource``: a quantity-skewed
    EMNIST pool on the packed layout with selection gating, and a sybil
    clique over MNIST) through the engine on the card, kernel route, and on
    the CPU, plain route, from the same draws: the card launches its kernels,
    trust and masks are identical, params within 2e-4."""
    from _idx_files import write_cache

    write_cache(tmp_path, n=600)
    if fleet == "sybil-mnist":
        ds = make_federated("sybil", 24, samples_per_client=40, source="mnist",
                            cache_dir=str(tmp_path))
        fed = fleet_fed(24, local_epochs=2, defense="foolsgold_sketch",
                        num_poisoners=6, num_starved=0, client_fraction=1.0)
        kernels = (local_sgd, fedavg_agg, sketch_similarity)
    else:
        ds = make_federated("emnist", 16, scenario="quantity_skew", samples_per_client=40,
                            cache_dir=str(tmp_path))
        fed = fleet_fed(16, defense="foolsgold_sketch", select_frac=0.5)
        kernels = (local_sgd_ragged, fedavg_agg, sketch_similarity)
    assert not ds.fallback
    rounds = 3
    card = FedARServer(small_model(32), fed, TaskRequirement(),
                       draws=_replayed_draws(rounds, ds.num_clients, cuda_device))
    cpu = FedARServer(small_model(32), fed, TaskRequirement(), device="cpu",
                      draws=_replayed_draws(rounds, ds.num_clients, "cpu"))
    data = card.engine.prepare_data(ds)
    assert ("packed" in data) == (fleet != "sybil-mnist")
    counts = [k.launches for k in kernels]
    card.run(data, rounds=rounds)
    assert all(k.launches == c + rounds for k, c in zip(kernels, counts))
    cpu.run(ds, rounds=rounds)
    for key in ("trust", "selected", "on_time"):
        np.testing.assert_array_equal(np.stack(card.history[key]),
                                      np.stack(cpu.history[key]))
    torch.testing.assert_close(card.state.params.cpu(), cpu.state.params,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name,argv", [
    ("quickstart_torch", ["--clients", "16", "--dataset", "emnist", "--scenario",
                          "quantity_skew", "--select_frac", "0.5"]),
    ("poisoning_defense_torch", ["--clients", "64", "--dataset", "emnist"]),
])
def test_examples_run_on_the_card_by_default(cuda_device, tmp_path, capsys, name, argv):
    """The two FedAR examples with no ``--device``, on IDX files: they run
    on the card and launch its kernels."""
    import importlib.util

    from _idx_files import write_cache

    write_cache(tmp_path, n=600)
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    before = fedavg_agg.launches
    mod.main(argv + ["--rounds", "2", "--samples", "30", "--cache_dir", str(tmp_path)])
    assert fedavg_agg.launches > before
    out = capsys.readouterr().out
    assert "fallback" not in out and "final" in out


# ---------------------------------------------------------------------------
# the client mesh over NCCL: 4 cards against the one-rank run on one card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_runs():
    """Every case of ``tests/_torch_mesh_jobs.py`` on a one-rank NCCL mesh
    (card 0), on four ranks (cards 0-3), and in this process without a
    mesh (the resident engine on card 0)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 NVIDIA GPUs (one NCCL rank a card)")
    import _torch_mesh_jobs as jobs
    from repro_torch.core.distributed import spawn

    cases = list(jobs.CASES)
    one = spawn(1, jobs.job, cases, "cuda", device="cuda")[0]
    four = spawn(4, jobs.job, cases, "cuda", device="cuda")
    resident = {name: jobs.run_case(name, 1, "cuda") for name in ("fedar", "qsgd8",
                                                                  "gated_packed")}
    return jobs, one, four, resident


@pytest.mark.parametrize("case", [
    "fedar", "fedavg", "async", "async_seq", "foolsgold", "foolsgold_sketch", "qsgd8",
    "qsgd4_async", "topk", "gated_packed", "padded", "drift", "chaos", "cohort"])
def test_nccl_mesh_matches_one_rank(nccl_runs, case):
    """Four NCCL ranks, one a card, against the one-rank run on one card:
    the bars of tests/test_torch_mesh.py (selected, on-time, trust and fault
    masks identical, params within 1e-4 and bit-identical on every rank)."""
    jobs, one, four, _ = nccl_runs
    jobs.check_case(one[case], [r[case] for r in four], case, 4)


def test_nccl_mesh_collectives_and_layout(nccl_runs):
    """The collectives over NCCL (bool masks as uint8, the tree reduce, a
    width-0 gather), the divisibility error, and each rank's uplink of N / 4
    packed rows."""
    jobs, _, four, _ = nccl_runs
    ops = [r["_ops"] for r in four]
    xs = np.stack([o["x"] for o in ops])
    for r in four:
        o = r["_ops"]
        np.testing.assert_allclose(o["psum"], xs.sum(0), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(o["tree"], xs.sum(0), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(o["gathered"],
                                      np.concatenate([p["mask"] for p in ops]))
        assert o["empty"] == (12, 0) and "divisible" in r["_divisible"]
        assert f"the fleet's {jobs.N}" in r["_local_fleet"]
        codes, scale = r["qsgd8"]["uplink_shapes"][0]
        assert codes == ((jobs.N // 4, r["qsgd8"]["dim"]), "uint8")
        assert scale == ((jobs.N // 4, 1), "float32")


@pytest.mark.parametrize("case", ["fedar", "qsgd8", "gated_packed"])
def test_one_rank_nccl_mesh_is_the_resident_engine(nccl_runs, case):
    """A one-rank NCCL mesh (``MeshComms`` over one card) gives the resident
    engine's results bit for bit."""
    _, one, _, resident = nccl_runs
    assert one[case]["mesh"] == (0, 1) and resident[case]["mesh"] is None
    for key in ("params_rounds", "trust", "selected", "on_time", "fg_history",
                "compress_residual"):
        np.testing.assert_array_equal(one[case][key], resident[case][key], err_msg=key)


def test_qsgd_uniforms_on_the_card_equal_the_cpu(cuda_device):
    """The QSGD uniforms are a counter hash in int64 tensor ops: the card
    draws the CPU's bits, and a block of client ids draws the rows of the
    whole fleet's table for those ids."""
    from repro_torch.convert import GeneratorDraws

    ids = torch.arange(512)
    card = GeneratorDraws(7, cuda_device).uniform(3, ids.to(cuda_device), 101_770)
    cpu = GeneratorDraws(7).uniform(3, ids, 101_770)
    assert torch.equal(card.cpu(), cpu)
    block = GeneratorDraws(7, cuda_device).uniform(3, ids[128:256].to(cuda_device), 101_770)
    assert torch.equal(block, card[128:256])
