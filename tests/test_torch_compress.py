"""The port's uplink compression against the reference package.

- The three codec oracles (``repro_torch.kernels.ref``) and their wrappers
  on CPU tensors against ``repro.kernels.ref`` and the Pallas kernels in
  interpret mode, bit-equal: 4 and 8 bits, odd D, duplicate indices, k = 0.
- ``QSGDCompression`` / ``TopKCompression.roundtrip`` against the
  reference's on the same ``(deltas, residual, transmit)`` and the
  reference's own uniforms, bit-equal, plus the strategy contracts.
- 5-round trajectories of ``async`` + qsgd-4 + ``foolsgold_sketch`` and
  ``fedar`` + top-k against the live reference with replayed draws.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    assert_bookkeeping_equal,
    assert_close_up_to_flips,
    run_both,
)

from repro.common.config import FedConfig as JFedConfig
from repro.core.compress import client_keys
from repro.core.compress import make_compression as jmake_compression
from repro.kernels import compress as jkernels
from repro.kernels import ref as jref
from repro_torch.common.config import FedConfig
from repro_torch.configs.fedar_mnist import fleet_fed, small_model
from repro_torch.convert import GeneratorDraws
from repro_torch.core import compress as tcompress
from repro_torch.core.compress import make_compression, make_residual
from repro_torch.core.engine import FedAREngine
from repro_torch.core.resources import TaskRequirement
from repro_torch.kernels import compress as codec
from repro_torch.kernels import ref

D = 97  # odd, so the 4-bit layout pads one nibble


# ------------------------------------------------------------ the codecs
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dim", [D, 96, 1])
def test_pack_unpack_match_reference(bits, dim):
    rng = np.random.default_rng(dim + bits)
    codes = rng.integers(0, 2 ** bits, (5, dim)).astype(np.int32)
    want = np.asarray(jref.pack_codes_ref(jnp.asarray(codes), bits=bits))
    pallas = np.asarray(jkernels.pack_codes(jnp.asarray(codes), bits=bits,
                                            interpret=True, block_d=128))
    np.testing.assert_array_equal(want, pallas)
    for fn in (ref.pack_codes_ref, codec.pack_codes):
        got = fn(torch.as_tensor(codes), bits=bits)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
    want_codes = np.asarray(jref.unpack_codes_ref(jnp.asarray(want), bits=bits,
                                                  dim=dim))
    np.testing.assert_array_equal(want_codes, codes)
    for fn in (ref.unpack_codes_ref, codec.unpack_codes):
        got = fn(torch.as_tensor(want), bits=bits, dim=dim)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want_codes)


def test_four_bit_layout_is_half_split():
    """byte j = code[j] | code[P + j] << 4 with P = ceil(D / 2), the odd
    row padded with a zero nibble: not an even/odd interleave."""
    codes = torch.arange(5, dtype=torch.int32)[None, :]  # D = 5, P = 3
    packed = ref.pack_codes_ref(codes, bits=4)
    assert packed.tolist() == [[0 | 3 << 4, 1 | 4 << 4, 2]]


@pytest.mark.parametrize("case", ["distinct", "duplicates", "k0"])
def test_topk_decode_matches_reference(case):
    rng = np.random.default_rng(7)
    n, k = 6, {"distinct": 9, "duplicates": 12, "k0": 0}[case]
    vals = rng.standard_normal((n, k)).astype(np.float32)
    if case == "distinct":
        idx = np.stack([rng.permutation(D)[:k] for _ in range(n)])
    else:
        # pairs and triples of one index, which must add
        idx = rng.integers(0, 4, (n, k))
    idx = idx.astype(np.int32)
    want = np.asarray(jref.topk_decode_ref(jnp.asarray(vals), jnp.asarray(idx), D))
    pallas = np.asarray(jkernels.topk_decode(jnp.asarray(vals), jnp.asarray(idx),
                                             D, interpret=True, block_d=128))
    np.testing.assert_array_equal(want, pallas)
    for fn in (ref.topk_decode_ref, codec.topk_decode):
        got = fn(torch.as_tensor(vals), torch.as_tensor(idx), D)
        assert got.shape == (n, D) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------- the strategies
def _feds(**kw):
    kw.setdefault("defense", "none")
    return (dataclasses.replace(JFedConfig(), **kw),
            dataclasses.replace(FedConfig(), **kw))


def _uplink(n=9, d=D, seed=0):
    rng = np.random.default_rng(seed)
    deltas = (rng.standard_normal((n, d)) * 0.01).astype(np.float32)
    residual = (rng.standard_normal((n, d)) * 0.002).astype(np.float32)
    deltas[4] = 0.0  # an all-zero row encodes and decodes to zeros
    residual[4] = 0.0
    transmit = np.ones(n, bool)
    transmit[[1, 6]] = False
    keys = client_keys(jax.random.PRNGKey(seed + 11), jnp.arange(n, dtype=jnp.int32))
    unif = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (d,)))(keys))
    return deltas, residual, transmit, keys, unif


@pytest.mark.parametrize("kw", [
    dict(compress="qsgd", compress_bits=4),
    dict(compress="qsgd", compress_bits=8),
    dict(compress="topk", compress_k=7),
    dict(compress="topk", compress_k=D),
], ids=["qsgd4", "qsgd8", "topk7", "topkD"])
def test_roundtrip_bit_equal_to_reference(kw):
    """Same deltas, residual, transmit mask and (for QSGD) the reference's
    own uniforms: decoded rows, residual and codes equal bit for bit."""
    jfed, fed = _feds(**kw)
    jc, tc = jmake_compression(jfed, D), make_compression(fed, D)
    deltas, residual, transmit, keys, unif = _uplink()
    jdec, jres, jpay = jc.roundtrip(jnp.asarray(deltas), jnp.asarray(residual),
                                    jnp.asarray(transmit), keys)
    tdec, tres, tpay = tc.roundtrip(torch.as_tensor(deltas),
                                    torch.as_tensor(residual),
                                    torch.as_tensor(transmit),
                                    torch.as_tensor(unif))
    np.testing.assert_array_equal(tdec.numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    if kw["compress"] == "qsgd":
        np.testing.assert_array_equal(tpay["codes"].numpy(), np.asarray(jpay["codes"]))
        np.testing.assert_array_equal(tpay["scale"].numpy(), np.asarray(jpay["scale"]))
    else:
        # the same kept set, whatever order each top-k lists it in; the
        # all-zero row 4 ties everywhere, and any k of its indices decode
        # to the same zeros
        rows = np.arange(len(deltas)) != 4
        np.testing.assert_array_equal(np.sort(tpay["idx"].numpy(), 1)[rows],
                                      np.sort(np.asarray(jpay["idx"]), 1)[rows])
    assert tc.payload_nbytes(D) == jc.payload_nbytes(D)
    assert tc.residual_dim(D) == jc.residual_dim(D) == D


@pytest.mark.parametrize("kw", [
    dict(compress="qsgd", compress_bits=4),
    dict(compress="qsgd", compress_bits=8),
    dict(compress="topk", compress_k=5),
], ids=["qsgd4", "qsgd8", "topk5"])
def test_error_feedback_telescopes_and_holds_silent_rows(kw):
    """Over rounds, sum(decoded) + final residual == sum(raw deltas) to fp32
    tolerance; a non-transmitting row sends exact zeros and keeps its
    residual bit for bit."""
    _, fed = _feds(**kw)
    c = make_compression(fed, D)
    n = 9
    draws = GeneratorDraws(5)
    res = make_residual(n, c.residual_dim(D))
    total_raw = torch.zeros(n, D)
    total_dec = torch.zeros(n, D)
    gen = torch.Generator().manual_seed(3)
    silent = torch.zeros(n, dtype=torch.bool)
    silent[2] = True
    for r in range(6):
        deltas = torch.randn(n, D, generator=gen) * 0.01
        unif = draws.uniform(r, torch.arange(n), D)
        dec, new_res, _ = c.roundtrip(deltas, res, ~silent, unif)
        assert torch.equal(dec[2], torch.zeros(D))
        assert torch.equal(new_res[2], res[2])
        total_raw += torch.where(silent[:, None], 0.0, deltas)
        total_dec += dec
        res = new_res
    torch.testing.assert_close(total_dec + res, total_raw, atol=1e-5, rtol=1e-5)


def test_payload_nbytes_match_reference():
    for kw in (dict(compress="none"), dict(compress="qsgd", compress_bits=4),
               dict(compress="qsgd", compress_bits=8),
               dict(compress="topk", compress_k=795)):
        jfed, fed = _feds(**kw)
        for dim in (25450, 101770, 97):
            if kw.get("compress_k", 0) > dim:
                continue
            assert (make_compression(fed, dim).payload_nbytes(dim)
                    == jmake_compression(jfed, dim).payload_nbytes(dim))


@pytest.mark.parametrize("kw,match", [
    (dict(compress="qsgd", compress_bits=3), "compress_bits"),
    (dict(compress="topk", compress_k=0), "compress_k"),
    (dict(compress="topk", compress_k=D + 1), "compress_k"),
    (dict(compress="qsgd", aggregation="async_seq"), "does not compose"),
    (dict(compress="topk", aggregation="async_seq"), "does not compose"),
    (dict(compress="gzip"), "unknown FedConfig.compress"),
])
def test_invalid_knobs_raise_as_the_reference_does(kw, match):
    jfed, fed = _feds(**kw)
    with pytest.raises(ValueError, match=match):
        jmake_compression(jfed, D)
    with pytest.raises(ValueError, match=match):
        make_compression(fed, D)


def test_engine_rejects_bad_knobs_and_kernel_route_on_cpu():
    with pytest.raises(ValueError, match="does not compose"):
        FedAREngine(small_model(8), fleet_fed(12, defense="none", compress="qsgd",
                                              aggregation="async_seq"),
                    TaskRequirement(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        FedAREngine(small_model(8), fleet_fed(12, defense="none", compress="qsgd",
                                              compress_impl="kernel"),
                    TaskRequirement(), device="cpu")


def test_generator_uniforms_are_keyed_by_seed_and_round():
    """Keyed by (seed, round, client id): a row depends on its client id
    alone, so a mesh rank's block of clients draws the one-device rows."""
    ids = torch.arange(4)
    a = GeneratorDraws(1).uniform(3, ids, 10)
    assert a.shape == (4, 10) and a.dtype == torch.float32
    assert ((a >= 0) & (a < 1)).all()
    assert torch.equal(a, GeneratorDraws(1).uniform(3, ids, 10))
    assert not torch.equal(a, GeneratorDraws(1).uniform(4, ids, 10))
    assert not torch.equal(a, GeneratorDraws(2).uniform(3, ids, 10))
    assert torch.equal(a[2:], GeneratorDraws(1).uniform(3, torch.tensor([2, 3]), 10))
    assert torch.equal(a[[3, 0]], GeneratorDraws(1).uniform(3, torch.tensor([3, 0]), 10))


@pytest.mark.parametrize("seed", [0, 3])
def test_generator_uniforms_are_uniform_and_uncorrelated(seed):
    """The counter hash's uniforms (64 clients x 8,192 coordinates, two
    rounds): mean 1/2 and variance 1/12 within 5 standard errors, a
    64-bin histogram within chi-square's 5-sigma band, no all-equal
    column, and no pair of rows, of adjacent columns, or of one client's
    rows in consecutive rounds correlated past 0.06 (4.3 sigma of 8,192
    samples is 0.047, the largest of 2,016 row pairs expected near it)."""
    n, d = 64, 8192
    draws = GeneratorDraws(seed)
    u = draws.uniform(0, torch.arange(n), d).double()
    m = u.numel()
    assert abs(u.mean().item() - 0.5) < 5 * (1 / 12 / m) ** 0.5
    assert abs(u.var().item() - 1 / 12) < 5 * (1 / 180 / m) ** 0.5
    hist = torch.histc(u, bins=64, min=0.0, max=1.0)
    chi2 = (((hist - m / 64) ** 2) / (m / 64)).sum().item()
    assert abs(chi2 - 63) < 5 * (2 * 63) ** 0.5
    assert (u.std(dim=0) > 0.1).all()
    rows = torch.corrcoef(u)
    rows.fill_diagonal_(0.0)
    assert rows.abs().max().item() < 0.06
    cols = torch.corrcoef(torch.stack([u[:, :-1].flatten(), u[:, 1:].flatten()]))
    assert abs(cols[0, 1].item()) < 0.06
    nxt = draws.uniform(1, torch.arange(n), d).double()
    per_client = [torch.corrcoef(torch.stack([u[i], nxt[i]]))[0, 1].item()
                  for i in range(n)]
    assert max(map(abs, per_client)) < 0.06


# --------------------------------------------------- 5-round trajectories
ROUNDS = 5
FORCE = np.isin(np.arange(12), [2, 7])  # lag-3 stragglers, as in test_torch_async
# Share of elements allowed outside 2e-4, each within one level (see
# assert_close_up_to_flips).  Measured on this config: one flipped 4-bit
# code in 5 x 12 x 25,450 encodes (round 3, client 4: u - floor(u) =
# 0.7191206 against a uniform of 0.7191201), which moves one element of the
# residual, the pending buffer, the params and the sketched history each;
# top-k: none.  1e-4 of the elements allows 2 in the params, 30 in each
# (12, 25,450) block.
FLIP_SHARE = 1e-4


@pytest.mark.parametrize("overrides", [
    dict(aggregation="async", compress="qsgd", compress_bits=4,
         defense="foolsgold_sketch"),
    dict(aggregation="fedar", compress="topk", defense="foolsgold_sketch"),
], ids=["async-qsgd4-sketch", "fedar-topk"])
def test_compressed_trajectory_matches_live_reference(overrides, monkeypatch):
    # the largest level of the run: QSGD's scale / L, top-k's largest kept
    # |value|, read off every payload the port decodes
    level = [0.0]
    decode = tcompress.QSGDCompression.decode
    decode_topk = tcompress.TopKCompression.decode

    def qsgd_decode(self, payload, dim):
        level[0] = max(level[0], payload["scale"].max().item() / self.levels)
        return decode(self, payload, dim)

    def topk_decode(self, payload, dim):
        level[0] = max(level[0], payload["vals"].abs().max().item())
        return decode_topk(self, payload, dim)

    monkeypatch.setattr(tcompress.QSGDCompression, "decode", qsgd_decode)
    monkeypatch.setattr(tcompress.TopKCompression, "decode", topk_decode)
    jstate, jouts, server, hist = run_both(ROUNDS, force=FORCE, **overrides)
    assert_bookkeeping_equal(jstate, jouts, server, hist)
    st = server.state
    assert st.compress_residual.shape == (12, server.dim)
    for name in ("params", "compress_residual", "pending_delta", "fg_history"):
        assert_close_up_to_flips(name, getattr(st, name).numpy(),
                                 np.asarray(getattr(jstate, name)),
                                 level=level[0], max_share=FLIP_SHARE)
    np.testing.assert_allclose(st.pending_weight.numpy(),
                               np.asarray(jstate.pending_weight),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(hist["acc"], np.asarray(jouts.acc), atol=2e-4)
    assert np.abs(st.compress_residual.numpy()).sum() > 0
