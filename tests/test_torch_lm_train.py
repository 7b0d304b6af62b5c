"""Federated LM training in the port against the reference, on the CPU:
the LM data layer (``token_stream``, ``corpus_skew``, ``data/pipeline.py``),
the flat view of nested LM params, ``Model.loss`` / ``loss_per_example``
and their gradients, ``LMClientModel.client_update``, whole federated
rounds through both engines, and the count sketch's tables.

Everything runs in fp32 at reduced size (``reduced()`` configs are fp32);
the reference's params cross through ``convert.lm_params_from_jax`` and
its threefry draws through ``convert.ReplayDraws``.  Tolerances: the loss
and its gradients within 1e-5, one client update within 2e-4, rounds with
trust and masks identical and params and the defense history within
atol = rtol = 2e-4 (the reference goldens' band).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import LMClientModel as JLMClientModel
from repro.configs import get_config as jget_config
from repro.configs.fedar_mnist import fleet_fed as jfleet_fed
from repro.core.defense import SketchedFoolsGold as JSketch
from repro.core.engine import FedAREngine as JEngine
from repro.core.engine import flatten as jflatten
from repro.core.resources import TaskRequirement as JReq
from repro.data import datasets as jds
from repro.data import pipeline as jpipe
from repro.data import scenarios as jscn
from repro.data import synthetic as jsyn
from repro.models import ssm as jssm
from repro.models.model import Model as JModel
from repro_torch.common.config import FedConfig
from repro_torch.configs import get_config
from repro_torch.configs.fedar_mnist import fleet_fed
from repro_torch.convert import ReplayDraws, lm_params_from_jax
from repro_torch.core.defense import SketchedFoolsGold
from repro_torch.core.engine import (FedAREngine, flatten, ordered_leaves, unflatten,
                                     with_leaves)
from repro_torch.core.resources import TaskRequirement
from repro_torch.data import datasets as tds
from repro_torch.data import pipeline as tpipe
from repro_torch.data import scenarios as tscn
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels.count_sketch import SKETCH_CHUNK, sketch_plan
from repro_torch.models.model import LMClientModel, Model

from _torch_parity import reference_draws

GRAD_TOL = 1e-5
# zamba2-7b's SSD gradient runs through exp of chunk cumsums: both fp32
# implementations land 2e-5 (2 layers) to 4e-4 (4 layers) from the float64
# gradient on the largest leaf (test_zamba_fp32_gradient_spread), so its
# gradients are held to the fp32 LM band of tests/test_torch_lm_model.py
ZAMBA_GRAD_TOL = 1e-4
UPDATE_TOL = 2e-4
ROUND_TOL = 2e-4
TINY = dict(num_layers=1, d_model=64, d_ff=128, vocab_size=128, num_heads=2,
            num_kv_heads=1)  # tests/test_system.py's tiny_lm_cfg
LOSS_CASES = [("tinyllama-1.1b", {}), ("zamba2-7b", {})]


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _tree_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _tree_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def reference(arch, seed=0, **over):
    """(port config, reference model, reference params as numpy leaves)."""
    jcfg = jget_config(arch).reduced(**over)
    jm = JModel(jcfg)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    return get_config(arch).reduced(**over), jm, tree


def _ssd_masked_before_exp(xd, logdecay, Bc, Cc, chunk, init_state=None,
                           unroll_chunks=False):
    """The reference's ``ssd_chunked`` with one repair: the gaps above the
    diagonal are masked to -inf before the exponential, as the port does.
    Same values; the reference's ``where(mask, exp(gap), 0)`` gives a NaN
    gradient wherever a masked gap overflows (ROADMAP R12)."""
    B, S, nh, hd = xd.shape
    st = Bc.shape[-1]
    nc = S // chunk
    xs = xd.reshape(B, nc, chunk, nh, hd).transpose(1, 0, 2, 3, 4)
    ls = logdecay.reshape(B, nc, chunk, nh).transpose(1, 0, 2, 3)
    Bs = Bc.reshape(B, nc, chunk, st).transpose(1, 0, 2, 3)
    Cs = Cc.reshape(B, nc, chunk, st).transpose(1, 0, 2, 3)
    state0 = jnp.zeros((B, nh, st, hd), jnp.float32) if init_state is None else init_state
    tri = (jnp.arange(chunk)[:, None] >= jnp.arange(chunk)[None, :])[None, :, :, None]

    def body(state, inp):
        xc, lc, bc, cc = inp
        lcum = jnp.cumsum(lc, axis=1)
        yin = jnp.einsum("bls,bnsh,bln->blnh", cc.astype(jnp.float32), state,
                         jnp.exp(lcum))
        cb = jnp.einsum("bis,bjs->bij", cc.astype(jnp.float32), bc.astype(jnp.float32))
        gap = lcum[:, :, None, :] - lcum[:, None, :, :]
        L = jnp.exp(jnp.where(tri, gap, -jnp.inf))
        xf = xc.astype(jnp.float32)
        yintra = jnp.einsum("bij,bijn,bjnh->binh", cb, L, xf)
        tail = lcum[:, -1:, :] - lcum
        cstate = jnp.einsum("bjs,bjn,bjnh->bnsh", bc.astype(jnp.float32),
                            jnp.exp(tail), xf)
        new_state = state * jnp.exp(lcum[:, -1])[:, :, None, None] + cstate
        return new_state, (yin + yintra).astype(xd.dtype)

    final, ys = jax.lax.scan(body, state0, (xs, ls, Bs, Cs))
    return ys.transpose(1, 0, 2, 3, 4).reshape(B, S, nh, hd), final


@pytest.fixture
def masked_reference_ssd(monkeypatch):
    monkeypatch.setattr(jssm, "ssd_chunked", _ssd_masked_before_exp)


def lm_batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


# ---------------------------------------------------------------------------
# data: token_stream, corpus_skew, the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_token_stream_equals_reference(seed):
    got = list(tsyn.token_stream(3, 4, 16, 97, seed=seed))
    want = list(jsyn.token_stream(3, 4, 16, 97, seed=seed))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _tree_equal(g, w)
        assert g["tokens"].dtype == np.int32


@pytest.mark.parametrize("samples", [None, 5])
def test_corpus_skew_is_label_skew_and_equals_reference(samples):
    topics = np.random.default_rng(4).integers(0, 6, 300)
    got = tscn.make_scenario("corpus_skew", topics, 10, samples, seed=2)
    want = jscn.make_scenario("corpus_skew", topics, 10, samples, seed=2)
    same = tscn.make_scenario("label_skew", topics, 10, samples, seed=2, alpha=0.3)
    for g, w, s in zip(got.client_indices, want.client_indices, same.client_indices):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)
    kw = dict(scenario="corpus_skew", samples_per_client=20, seed=5)
    _tree_equal(tds.make_federated("digits", 12, **kw).arrays(),
                jds.make_federated("digits", 12, **kw).arrays())


@pytest.mark.parametrize("kw", [
    dict(),
    dict(poisoners=(1, 3), seed=7),
    dict(scenario="quantity_skew", topics=3),
    dict(samples_per_client=5, eval_sequences=9, alpha=0.05),
])
def test_federated_lm_corpus_equals_reference(kw):
    args = dict(vocab=61, seq=12, samples_per_client=8)
    args.update(kw)
    got, gmeta = tpipe.federated_lm_corpus(6, **args)
    want, wmeta = jpipe.federated_lm_corpus(6, **args)
    _tree_equal(got, want)
    _tree_equal(gmeta["eval"], wmeta["eval"])
    np.testing.assert_array_equal(gmeta["topic_of"], wmeta["topic_of"])
    for g, w in zip(gmeta["plan"].client_indices, wmeta["plan"].client_indices):
        np.testing.assert_array_equal(g, w)
    assert got["tokens"].dtype == np.int32 and got["sizes"].dtype == np.float32
    with pytest.raises(ValueError, match="topics"):
        tpipe.federated_lm_corpus(2, vocab=3, seq=4, samples_per_client=2, topics=4)


@pytest.mark.parametrize("patches", [False, True])
def test_lm_batches_equal_reference(patches):
    cfg, jcfg = get_config("tinyllama-1.1b").reduced(), jget_config("tinyllama-1.1b").reduced()
    got = list(tpipe.lm_batches(cfg, batch=3, seq=8, steps=2, seed=1, patches=patches))
    want = list(jpipe.lm_batches(jcfg, batch=3, seq=8, steps=2, seed=1, patches=patches))
    for g, w in zip(got, want):
        assert set(g) == set(w) == ({"tokens", "labels", "patches"} if patches
                                     else {"tokens", "labels"})
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


# ---------------------------------------------------------------------------
# the flat view of nested params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-7b"])
def test_flat_view_is_the_reference_stacked_tree(arch):
    """The port's per-layer lists flatten to the reference's stacked tree's
    flat vector bit for bit, and unflatten gives the port tree back."""
    cfg, _, tree = reference(arch, num_layers=4)
    params = lm_params_from_jax(tree, cfg, "cpu")
    flat = flatten(params)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflatten(tree)))
    back = unflatten(flat, params)
    assert len(back["layers"]) == 4
    for (pa, a), (pb, b) in zip(ordered_leaves(back), ordered_leaves(params)):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_bf16_template_round_trips_exactly():
    cfg = get_config("tinyllama-1.1b").reduced(num_layers=3, dtype="bfloat16")
    params = Model(cfg, "cpu").init_params(torch.Generator().manual_seed(0))
    flat = flatten(params)
    assert flat.dtype == torch.float32
    back = unflatten(flat, params)
    dtypes = set()
    for (_, a), (_, b) in zip(ordered_leaves(back), ordered_leaves(params)):
        assert a.dtype == b.dtype
        dtypes.add(a.dtype)
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    assert dtypes == {torch.bfloat16, torch.float32}
    rows = torch.stack([flat, flat + 1])
    np.testing.assert_array_equal(
        flatten({"a": rows[:, :5].reshape(2, 5), "b": rows[:, 5:9]}, rows=True).numpy(),
        rows[:, :9].numpy())
    with pytest.raises(ValueError, match="differ in structure"):
        flatten({"layers": [{"a": flat[:2]}, {"a": flat[:2], "b": flat[:1]}]})


# ---------------------------------------------------------------------------
# Model.loss and its gradients
# ---------------------------------------------------------------------------

def _port_grads(m, params, fn):
    leaves = [leaf.clone().requires_grad_(True) for _, leaf in ordered_leaves(params)]
    value = fn(with_leaves(params, leaves))
    grads = torch.autograd.grad(value, leaves)
    return value, torch.cat([g.reshape(-1) for g in grads])


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("loss_chunk", [0, 8])
@pytest.mark.parametrize("arch,over", LOSS_CASES)
def test_loss_and_grads_match_reference(arch, over, loss_chunk, remat,
                                        masked_reference_ssd):
    cfg, jm, tree = reference(arch, **over)
    batch = lm_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    m = Model(cfg, "cpu")
    params = lm_params_from_jax(tree, cfg, "cpu")

    def jrows(p):
        return jm.loss_per_example(p, jb, remat=remat, loss_chunk=loss_chunk)[0]

    @jax.jit
    def jall(p):  # one compile: the loss, its gradient, the rows, theirs
        want, jgrad = jax.value_and_grad(
            lambda q: jm.loss(q, jb, remat=remat, loss_chunk=loss_chunk)[0])(p)
        return want, jgrad, jrows(p), jax.grad(lambda q: jnp.mean(jrows(q)))(p)

    want, jgrad, jrow_loss, jg = jall(jax.tree.map(jnp.asarray, tree))
    got, grad = _port_grads(m, params, lambda p: m.loss(p, batch, remat=remat,
                                                        loss_chunk=loss_chunk)[0])
    gtol = GRAD_TOL if arch == "tinyllama-1.1b" else ZAMBA_GRAD_TOL
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jflatten(jgrad)),
                               rtol=gtol, atol=gtol)
    # per example, and the gradient of their mean
    rows, aux = m.loss_per_example(params, batch, remat=remat, loss_chunk=loss_chunk)
    assert rows.shape == (2,) and float(aux) == 0.0
    np.testing.assert_allclose(_np(rows), np.asarray(jrow_loss), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    _, g = _port_grads(m, params, lambda p: m.loss_per_example(
        p, batch, remat=remat, loss_chunk=loss_chunk)[0].mean())
    np.testing.assert_allclose(g.numpy(), np.asarray(jflatten(jg)), rtol=gtol, atol=gtol)


def test_zamba_fp32_gradient_spread(masked_reference_ssd):
    """Why zamba2-7b's gradients take ZAMBA_GRAD_TOL: against the port's
    float64 gradient (the same function at double precision), the
    reference's fp32 gradient is itself more than GRAD_TOL away, and the
    port's lands within the same order."""
    cfg, jm, tree = reference("zamba2-7b")
    batch = lm_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrad = np.asarray(jflatten(jax.grad(lambda p: jm.loss(p, jb)[0])(
        jax.tree.map(jnp.asarray, tree))))
    m = Model(cfg, "cpu")
    p32 = lm_params_from_jax(tree, cfg, "cpu")
    p64 = with_leaves(p32, [leaf.to(torch.float64) for _, leaf in ordered_leaves(p32)])
    _, g64 = _port_grads(m, p64, lambda p: m.loss(p, batch)[0])
    _, g32 = _port_grads(m, p32, lambda p: m.loss(p, batch)[0])
    ref_spread = np.abs(jgrad - g64.numpy()).max()
    port_spread = np.abs(g32.numpy() - g64.numpy()).max()
    assert GRAD_TOL < ref_spread < ZAMBA_GRAD_TOL
    assert port_spread < ZAMBA_GRAD_TOL


def test_reference_zamba_gradient_is_nan_and_the_port_finite():
    """ROADMAP R12: at the reduced zamba2-7b's random init a masked SSD gap
    overflows, and the reference's ``where(mask, exp(gap), 0)`` turns its
    loss gradient NaN; the port's loss is the same and its gradient finite
    (held against the repaired reference above)."""
    cfg, jm, tree = reference("zamba2-7b")
    batch = lm_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jgrad = jax.value_and_grad(lambda p: jm.loss(p, jb)[0])(
        jax.tree.map(jnp.asarray, tree))
    assert not np.isfinite(np.asarray(jflatten(jgrad))).all()
    m = Model(cfg, "cpu")
    got, grad = _port_grads(m, lm_params_from_jax(tree, cfg, "cpu"),
                            lambda p: m.loss(p, batch)[0])
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=GRAD_TOL, atol=GRAD_TOL)
    assert torch.isfinite(grad).all()


def test_loss_takes_the_plain_routes(monkeypatch):
    """Kernels 8 and 9 have no backward: the loss asks for the plain routes
    whatever the model's own are (ROADMAP Trap 5)."""
    from repro_torch.kernels import ops

    cfg, _, tree = reference("zamba2-7b")
    m = Model(cfg, "cpu")
    m.attn_impl = m.ssm_impl = "kernel"  # the card's routes
    calls = []
    monkeypatch.setattr(ops, "resolve_impl", lambda name, kind, device: (
        calls.append((name, kind)) or "einsum"))
    m.loss(lm_params_from_jax(tree, cfg, "cpu"), lm_batch(cfg))
    assert calls and all(name == "einsum" for name, _ in calls)
    assert {kind for _, kind in calls} == {"attn", "ssm"}


# ---------------------------------------------------------------------------
# LMClientModel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_client_update_matches_reference(masked):
    """One client's ClientUpdate, E = 2 epochs of batch 4 over 10
    sequences: unmasked the batch count floors (2 batches), masked it ceils
    (3, the last padded with mask-False rows)."""
    cfg, _, tree = reference("tinyllama-1.1b", **TINY)
    jmodel = JLMClientModel(jget_config("tinyllama-1.1b").reduced(**TINY))
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab_size, (10, 16)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (10, 16)).astype(np.int32)
    mask = np.arange(10) < 9 if masked else None
    want = jmodel.client_update(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
        lr=0.05, batch_size=4, epochs=2,
        sample_mask=None if mask is None else jnp.asarray(mask))
    model = LMClientModel(cfg, device="cpu")
    got = model.client_update(
        lm_params_from_jax(tree, cfg, "cpu"), {"tokens": _t(tok[None]), "labels": _t(lab[None])},
        lr=0.05, batch_size=4, epochs=2,
        sample_mask=None if mask is None else _t(mask[None]))
    assert got.shape == (1, flatten(lm_params_from_jax(tree, cfg, "cpu")).numel())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jflatten(want)),
                               rtol=UPDATE_TOL, atol=UPDATE_TOL)
    moved = (got[0] - flatten(lm_params_from_jax(tree, cfg, "cpu"))).abs().max()
    assert moved > 1e-3


def test_client_update_keeps_each_leaf_dtype():
    """A bf16 model trains its bf16 leaves in bf16 and its norms in fp32;
    the flat rows are fp32 and an all-padding client does not move."""
    cfg = get_config("tinyllama-1.1b").reduced(**TINY, dtype="bfloat16")
    model = LMClientModel(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    tok = _t(rng.integers(0, cfg.vocab_size, (2, 6, 8)))
    mask = torch.tensor([[True] * 6, [False] * 6])
    rows = model.client_update(params, {"tokens": tok, "labels": tok}, lr=0.1,
                               batch_size=4, epochs=1, sample_mask=mask)
    assert rows.dtype == torch.float32
    start = flatten(params)
    assert torch.equal(rows[1], start)
    assert (rows[0] != start).any()
    back = unflatten(rows[0], params)
    for (_, a), (_, b) in zip(ordered_leaves(back), ordered_leaves(params)):
        assert a.dtype == b.dtype
    assert model.train_flops((6, 8), epochs=2) == 6.0 * 2 * 6 * 8 * start.numel()


def test_metrics_match_reference():
    cfg, _, tree = reference("tinyllama-1.1b", **TINY)
    jmodel = JLMClientModel(jget_config("tinyllama-1.1b").reduced(**TINY))
    ev = lm_batch(cfg, B=5, S=12, seed=8)
    want = jmodel.metrics(jax.tree.map(jnp.asarray, tree),
                          {k: jnp.asarray(v) for k, v in ev.items()})
    got = LMClientModel(cfg, device="cpu").metrics(lm_params_from_jax(tree, cfg, "cpu"),
                                                  {k: _t(v) for k, v in ev.items()})
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=GRAD_TOL, atol=GRAD_TOL)
    assert float(got[1]) == float(want[1])


def test_lm_client_refuses_the_kernel_route_and_the_packed_layout():
    cfg = get_config("tinyllama-1.1b").reduced(**TINY)
    fed = fleet_fed(4, sgd_impl="kernel", defense="none", local_epochs=1,
                    local_batch_size=4)
    # the reference warns and falls back (tests/test_client_model.py); the
    # port has no fallback
    with pytest.raises(ValueError, match="family 'lm' has none"):
        FedAREngine(LMClientModel(cfg, device="cpu"), fed, TaskRequirement(),
                    device="cpu")
    engine = FedAREngine(LMClientModel(cfg, device="cpu"),
                         fleet_fed(4, defense="none"), TaskRequirement(), device="cpu")
    assert engine.sgd_route == "einsum"
    with pytest.raises(ValueError, match="does not support the bucketed"):
        engine.step(engine.init_state(), {"packed": {"shards": 1}})
    with pytest.raises(ValueError, match="engine runs on"):
        LMClientModel(cfg, device="cpu").init(torch.Generator(), "cuda")


# ---------------------------------------------------------------------------
# federated rounds through both engines
# ---------------------------------------------------------------------------

ROUND_CASES = {
    "fedar+sketch": dict(aggregation="fedar", defense="foolsgold_sketch", timeout=10.0),
    "async+sketch": dict(aggregation="async", defense="foolsgold_sketch", timeout=10.0),
    "fedavg+none": dict(aggregation="fedavg", defense="none"),
}


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_lm_rounds_match_reference(case):
    """3 rounds of tests/test_system.py's tiny LM fleet (6 clients, 8
    sequences of 32 each, corpus_skew, two poisoners) through the reference
    engine and the port's, from the same init params and draws; clients 1
    and 4 forced to straggle."""
    N, rounds, seed = 6, 3, 1
    kw = dict(local_epochs=1, local_batch_size=4, timeout=1e9, seed=seed)
    kw.update(ROUND_CASES[case])
    jcfg = jget_config("tinyllama-1.1b").reduced(**TINY)
    cfg = get_config("tinyllama-1.1b").reduced(**TINY)
    jeng = JEngine(JLMClientModel(jcfg), jfleet_fed(N, **kw), JReq(), lr=0.05)
    poisoners = tuple(int(i) for i in np.where(np.asarray(jeng.poison_mask))[0])
    corpus = dict(vocab=cfg.vocab_size, seq=32, samples_per_client=8, topics=4,
                  seed=seed, poisoners=poisoners)
    data, meta = jpipe.federated_lm_corpus(N, **corpus)
    assert "mask" in data
    force = np.isin(np.arange(N), (1, 4))
    jstate, jouts = jeng.run(jeng.init_state(), {k: jnp.asarray(v) for k, v in data.items()},
                             rounds=rounds,
                             eval_set={k: jnp.asarray(v) for k, v in meta["eval"].items()},
                             force_straggler=jnp.asarray(force))
    tree = jax.tree.map(np.asarray, jeng.template)
    engine = FedAREngine(
        LMClientModel(cfg, device="cpu"), fleet_fed(N, **kw), TaskRequirement(), lr=0.05,
        device="cpu", draws=ReplayDraws(**reference_draws(seed, rounds, N)),
        init_params=lm_params_from_jax(tree, cfg, "cpu"))
    tdata, tmeta = tpipe.federated_lm_corpus(N, **corpus)
    state, outs = engine.run(engine.init_state(), tdata, rounds=rounds,
                             eval_set=tmeta["eval"], force_straggler=force)
    for name in ("selected", "on_time"):
        np.testing.assert_array_equal(outs._asdict()[name].numpy(),
                                      np.asarray(getattr(jouts, name)))
    np.testing.assert_array_equal(outs.trust.numpy(), np.asarray(jouts.trust))
    np.testing.assert_array_equal(state.trust.score.numpy(), np.asarray(jstate.trust.score))
    np.testing.assert_allclose(state.params.numpy(), np.asarray(jstate.params),
                               rtol=ROUND_TOL, atol=ROUND_TOL)
    np.testing.assert_allclose(state.fg_history.numpy(), np.asarray(jstate.fg_history),
                               rtol=ROUND_TOL, atol=ROUND_TOL)
    np.testing.assert_allclose(outs.loss.numpy(), np.asarray(jouts.loss),
                               rtol=ROUND_TOL, atol=ROUND_TOL)
    if kw["aggregation"] == "async":
        np.testing.assert_array_equal(state.pending_valid.numpy(),
                                      np.asarray(jstate.pending_valid))
        np.testing.assert_allclose(state.pending_delta.numpy(),
                                   np.asarray(jstate.pending_delta),
                                   rtol=ROUND_TOL, atol=ROUND_TOL)
    assert (state.params != flatten(engine.template)).any()
    assert np.isfinite(outs.loss.numpy()).all()


# ---------------------------------------------------------------------------
# the count sketch in O(D)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,r", [(5000, 256), (101_770, 256), (SKETCH_CHUNK * 3 + 1, 7)])
def test_count_sketch_matches_reference_scatter(D, r):
    fed = FedConfig(defense="foolsgold_sketch", seed=3, defense_sketch_dim=r)
    from repro.common.config import FedConfig as JFedConfig

    ours = SketchedFoolsGold(fed, D, "cpu")
    theirs = JSketch(JFedConfig(defense="foolsgold_sketch", seed=3,
                                defense_sketch_dim=r), D)
    np.testing.assert_array_equal(ours.bucket.numpy(), np.asarray(theirs.bucket))
    np.testing.assert_array_equal(ours.sign.numpy(), np.asarray(theirs.sign))
    rows = np.random.default_rng(9).standard_normal((5, D)).astype(np.float32) * 0.01
    np.testing.assert_allclose(ours.sketch(_t(rows)).numpy(),
                               np.asarray(theirs.sketch(jnp.asarray(rows))),
                               rtol=1e-6, atol=1e-6)
    # the kept tables: no (D, r) matrix, at most 8 bytes a coordinate
    assert not hasattr(ours, "proj")
    kept = sum(t.numel() * t.element_size() for t in ours.tables)
    assert kept <= 8 * D
    ent, start = ours.tables
    assert ent.dtype == start.dtype == torch.int16
    assert start.shape == (-(-D // SKETCH_CHUNK), r + 1)
    segs, per_seg = sketch_plan(D)
    assert (segs - 1) * per_seg < start.shape[0] <= segs * per_seg


def test_count_sketch_tables_are_sorted_runs():
    """Each chunk's entries list its coordinates bucket by bucket, in
    ascending order within a bucket; the run starts count them."""
    sk = SketchedFoolsGold(FedConfig(defense="foolsgold_sketch"), 3 * SKETCH_CHUNK - 5, "cpu")
    ent, start = sk.tables
    bucket = sk.bucket
    for c in range(start.shape[0]):
        off = (ent[c * SKETCH_CHUNK:(c + 1) * SKETCH_CHUNK].to(torch.int64) & 0x7FFF)
        coord = c * SKETCH_CHUNK + off
        b = bucket[coord]
        assert torch.equal(b, torch.sort(b, stable=True).values)
        for k in range(sk.r):
            lo, hi = int(start[c, k]), int(start[c, k + 1])
            assert (b[lo:hi] == k).all()
            assert (coord[lo:hi].diff() > 0).all()
        assert int(start[c, -1]) == coord.numel()


def test_engines_of_one_model_share_the_sketch_tables():
    """The tables depend on (seed, D, r) alone: a second engine of the same
    model (a route check's, say) reuses them while the first lives."""
    import gc

    from repro_torch.core import defense

    fed = FedConfig(defense="foolsgold_sketch", seed=11)
    a = SketchedFoolsGold(fed, 7000, "cpu")
    b = SketchedFoolsGold(FedConfig(defense="foolsgold_sketch", seed=11,
                                    defense_impl="einsum"), 7000, "cpu")
    assert a.tables[0] is b.tables[0] and b.impl == "einsum"
    assert SketchedFoolsGold(FedConfig(defense="foolsgold_sketch", seed=12),
                             7000, "cpu").tables[0] is not a.tables[0]
    key = (11, 7000, 256, "cpu")
    assert key in defense._SHARED
    del a, b
    gc.collect()
    assert key not in defense._SHARED
