"""The xLSTM kind and the two stubbed frontends in the port against the
reference, on the CPU: ``xlstm-350m`` ((sLSTM, mLSTM) pairs),
``internvl2-1b`` (projected vision patches ahead of the text) and
``musicgen-medium`` (codec token ids; the audio stub has no params), at
``reduced()`` from the reference's params (``convert.lm_params_from_jax``).
xlstm-350m runs two pairs (``num_layers=4``).

The mLSTM's chunkwise-parallel form is held against the reference's at
chunks 16 and 128, from a zero and from a carried state; the mLSTM and
sLSTM decode steps against their forwards and against the reference's
steps.  The reference's chunk body takes ``where(mask, exp(gap), 0)``,
whose gradient is 0 * inf = NaN once a chunk's summed log forget gates
pass ~88 (ROADMAP R13); the port masks the gap to -inf before the
exponential, and is held against a copy of the reference's body with that
one repair.  Then ``Model.prefill`` / ``forward``, 40 decode steps (and
internvl2-1b's decode after priming the cache with the patch positions,
as ``tests/test_decode.py`` primes it), ``Model.loss`` and its gradients,
the cache converters and one xLSTM client update.  The model-level xLSTM
runs use S = 256, two mLSTM chunks, so the carried state is exercised.
Everything runs in fp32; the tolerance is 1e-4 (the fp32 LM band of
``tests/test_torch_lm_model.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import LMClientModel as JLMClientModel
from repro.configs import get_config as jget_config
from repro.core.engine import flatten as jflatten
from repro.models import blocks as jblocks
from repro.models import xlstm as jxlstm
from repro.models.model import Model as JModel
from repro.models.model import VISION_STUB_DIM as J_VISION_STUB_DIM
from repro_torch.configs import PORTED, get_config
from repro_torch.convert import lm_cache_from_jax, lm_cache_to_numpy, lm_params_from_jax
from repro_torch.core.engine import flatten, ordered_leaves, with_leaves
from repro_torch.models import blocks, xlstm
from repro_torch.models.model import (VISION_STUB_DIM, LMClientModel, Model, layer_windows,
                                      model_kind, num_blocks, param_count)

TOL = 1e-4
ARCHS = ("xlstm-350m", "internvl2-1b", "musicgen-medium")
OVER = {"xlstm-350m": (("num_layers", 4),), "internvl2-1b": (), "musicgen-medium": ()}
S_XLSTM, S_ATTN, PROMPT, STEPS = 256, 48, 16, 40


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The sLSTM runs thousands of tiny ops; when parallel test workers
    share the cores, PyTorch's intra-op thread pool makes each of them
    wait on the others (~9x slower on 8 busy cores), so this module runs
    on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


@functools.lru_cache(maxsize=None)
def reference(arch, over_items=None):
    """(port config, reference model, its params as numpy leaves, the port's
    params converted from them, the port's CPU model)."""
    over = dict(OVER[arch] if over_items is None else over_items)
    jcfg = jget_config(arch).reduced(**over)
    jm = JModel(jcfg)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    cfg = get_config(arch).reduced(**over)
    return cfg, jm, tree, lm_params_from_jax(tree, cfg, "cpu"), Model(cfg, device="cpu")


def make_batch(cfg, B, T, seed=0, labels=False):
    """Numpy tokens (and labels) of T text positions, and for the vision
    stub ``num_patches`` standard-normal patches of width 1,024."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    if labels:
        batch["labels"] = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    if cfg.frontend == "vision_stub":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_patches, VISION_STUB_DIM)).astype(np.float32)
    return batch


def _seq(arch):
    return S_XLSTM if arch == "xlstm-350m" else S_ATTN


# ---------------------------------------------------------------------------
# configs and trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_by_field(arch):
    assert arch in PORTED
    cfg, jcfg = get_config(arch), jget_config(arch)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    for over in ({}, dict(num_layers=4), dict(dtype="bfloat16")):
        assert (dataclasses.asdict(cfg.reduced(**over))
                == dataclasses.asdict(jcfg.reduced(**over)))
    assert VISION_STUB_DIM == J_VISION_STUB_DIM == 1024
    if arch == "xlstm-350m":
        assert model_kind(cfg) == "xlstm" and num_blocks(cfg) == 12
        assert xlstm.mlstm_dims(cfg) == (2048, 4, 512) and xlstm.slstm_dims(cfg) == (4, 256)
        assert num_blocks(cfg.reduced()) == 1 and num_blocks(cfg.reduced(num_layers=4)) == 2
    elif arch == "internvl2-1b":
        assert model_kind(cfg) == "attn" and cfg.frontend == "vision_stub"
        assert cfg.num_patches == 256 and cfg.reduced().num_patches == 16
        assert (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) == (14, 2, 64)
    else:
        assert model_kind(cfg) == "attn" and cfg.frontend == "audio_stub"
        assert (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) == (24, 24, 64)
        assert cfg.act == "gelu" and cfg.reduced().num_kv_heads == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_models_build_on_the_card_by_default(arch):
    """``device=None`` is the card; without one it raises, and the CPU is
    asked for by name."""
    cfg = get_config(arch)
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Model(cfg)
    assert Model(cfg, device="cpu").kind == model_kind(cfg)


def _tree_meta(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_trees_match_the_reference(arch):
    """The port's seeded init against ``jax.eval_shape`` of the reference's,
    in bf16 so that the per-leaf dtype rule shows: the same keys and
    shapes, ``vision_proj`` for the vision stub, no params for the audio
    stub, and the xLSTM's gate weights and biases in fp32."""
    over = dict(OVER[arch], dtype="bfloat16")
    cfg = get_config(arch).reduced(**over)
    jtree = jax.eval_shape(JModel(jget_config(arch).reduced(**over)).init_params,
                           jax.random.PRNGKey(0))
    params = Model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    assert len(params["layers"]) == num_blocks(cfg)
    jl = jax.tree.map(lambda a: (a.shape[1:], str(a.dtype)), jtree["layers"])
    tl = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), params["layers"][0])
    assert tl == jl
    top = {k: v for k, v in params.items() if k != "layers"}
    assert (jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), top)
            == {k: v for k, v in _tree_meta(jtree).items() if k != "layers"})
    assert ("vision_proj" in params) == (cfg.frontend == "vision_stub")
    if arch == "xlstm-350m":
        lp = params["layers"][0]
        for sub, key in (("slstm", "wx"), ("slstm", "r"), ("slstm", "bias"),
                         ("mlstm", "wif"), ("mlstm", "if_bias"), ("mlstm", "norm")):
            assert lp[sub][key].dtype == torch.float32, (sub, key)
        assert lp["slstm"]["out_proj"].dtype == lp["mlstm"]["wqkv"].dtype == torch.bfloat16
        np.testing.assert_array_equal(lp["slstm"]["bias"][1].numpy(), 3.0)
        np.testing.assert_array_equal(lp["mlstm"]["if_bias"].numpy()[:, 0], [-3.0, 3.0])
    assert param_count(params) == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jtree))


def test_params_converter_keeps_the_xlstm_gates_fp32():
    """``lm_params_from_jax`` on a bf16 xLSTM tree with ``dtype=bf16``: the
    fp32 leaves (``wx``, ``r``, ``bias``, ``wif``, ``if_bias``, the norms)
    stay fp32 and bit-equal, every other weight keeps bf16, one entry a
    pair; a tree whose pair count disagrees with the config is refused."""
    jcfg = jget_config("xlstm-350m").reduced(num_layers=4, dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JModel(jcfg).init_params(jax.random.PRNGKey(1)))
    cfg = get_config("xlstm-350m").reduced(num_layers=4, dtype="bfloat16")
    params = lm_params_from_jax(tree, cfg, "cpu", dtype=torch.bfloat16)
    assert len(params["layers"]) == 2
    fp32 = {("slstm", "wx"), ("slstm", "r"), ("slstm", "bias"), ("mlstm", "wif"),
            ("mlstm", "if_bias"), ("mlstm", "norm")}
    for i, lp in enumerate(params["layers"]):
        assert lp["ln_s"].dtype == lp["ln_m"].dtype == torch.float32
        for sub in ("slstm", "mlstm"):
            for key, leaf in lp[sub].items():
                want = torch.float32 if (sub, key) in fp32 else torch.bfloat16
                assert leaf.dtype == want, (sub, key)
                np.testing.assert_array_equal(_np(leaf),
                                              np.asarray(tree["layers"][sub][key][i],
                                                         np.float32))
    with pytest.raises(ValueError, match="blocks"):
        lm_params_from_jax(tree, cfg.reduced(num_layers=6), "cpu")


# ---------------------------------------------------------------------------
# the mLSTM's chunked form, and the R13 repair
# ---------------------------------------------------------------------------

def _mlstm_inputs(B=2, S=256, nh=4, hd=32, seed=0, forget_bias=3.0):
    """q, k, v (B, S, nh, hd) and the fp32 log forget gate and input-gate
    pre-activation (B, S, nh), as numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, nh, hd)).astype(np.float32) for _ in range(3))
    fg = forget_bias + rng.standard_normal((B, S, nh)).astype(np.float32)
    logf = np.asarray(jax.nn.log_sigmoid(jnp.asarray(fg)))
    logi = (-3.0 + rng.standard_normal((B, S, nh))).astype(np.float32)
    return q, k, v, logf, logi


@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "carried-state"])
@pytest.mark.parametrize("chunk", [16, 128])
def test_mlstm_chunked_matches_reference(chunk, with_state):
    """``_mlstm_chunked`` over 256 positions: the output and the final fp32
    state, from a zero state or from a given one."""
    q, k, v, logf, logi = _mlstm_inputs()
    state = None
    if with_state:
        state = np.random.default_rng(7).standard_normal((2, 4, 32, 33)).astype(np.float32)
    jy, jstate = jxlstm._mlstm_chunked(*(jnp.asarray(a) for a in (q, k, v, logf, logi)),
                                       chunk, None if state is None else jnp.asarray(state))
    y, st = xlstm._mlstm_chunked(*(_t(a) for a in (q, k, v, logf, logi)), chunk,
                                 None if state is None else _t(state))
    assert y.shape == (2, 256, 4, 32) and st.shape == (2, 4, 32, 33)
    assert st.dtype == torch.float32
    _close(_np(y), jy)
    _close(_np(st), jstate)


def test_mlstm_chunked_refuses_a_ragged_chunk_count():
    """Where S passes the chunk and does not divide by it the reference's
    reshape fails; the port raises naming the chunk, and does not pad."""
    cfg = get_config("xlstm-350m").reduced()
    p = xlstm.init_mlstm(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    with pytest.raises(ValueError, match="chunk 128"):
        xlstm.mlstm_forward(p, torch.zeros(1, 200, cfg.d_model), cfg)
    with pytest.raises(ValueError, match="chunk 16"):
        xlstm._mlstm_chunked(*(_t(a) for a in _mlstm_inputs(S=40)), 16)
    # shorter than the chunk: one chunk of S
    assert xlstm.mlstm_forward(p, torch.zeros(1, 40, cfg.d_model), cfg).shape == (1, 40, 256)


def _repaired_chunked(q, k, v, logf, logi, chunk):
    """The reference's ``_mlstm_chunked`` (``src/repro/models/xlstm.py``)
    with one line changed: the gap is masked to -inf before the
    exponential instead of after it."""
    B, S, nh, hd = q.shape
    nc = S // chunk
    vp = jnp.concatenate([v, jnp.ones(v.shape[:-1] + (1,), v.dtype)], axis=-1)
    iw = jnp.exp(logi)
    qs = q.reshape(B, nc, chunk, nh, hd).transpose(1, 0, 2, 3, 4)
    ks_ = k.reshape(B, nc, chunk, nh, hd).transpose(1, 0, 2, 3, 4)
    vs = vp.reshape(B, nc, chunk, nh, hd + 1).transpose(1, 0, 2, 3, 4)
    ls = logf.reshape(B, nc, chunk, nh).transpose(1, 0, 2, 3)
    iws = iw.reshape(B, nc, chunk, nh).transpose(1, 0, 2, 3)

    def body(state, inp):
        qc, kc, vc, lc, ic = inp
        qf = qc.astype(jnp.float32) * hd ** -0.5
        kf = kc.astype(jnp.float32)
        vf = vc.astype(jnp.float32) * ic[..., None]
        lcum = jnp.cumsum(lc, axis=1)
        yin = jnp.einsum("blnk,bnkv,bln->blnv", qf, state, jnp.exp(lcum))
        qk = jnp.einsum("bink,bjnk->bijn", qf, kf)
        gap = lcum[:, :, None, :] - lcum[:, None, :, :]
        Lm = jnp.exp(jnp.where(
            (jnp.arange(chunk)[:, None] >= jnp.arange(chunk)[None, :])[None, :, :, None],
            gap, -jnp.inf))  # the repair
        yintra = jnp.einsum("bijn,bjnv->binv", qk * Lm, vf)
        tail = lcum[:, -1:, :] - lcum
        cstate = jnp.einsum("bjnk,bjn,bjnv->bnkv", kf, jnp.exp(tail), vf)
        new_state = state * jnp.exp(lcum[:, -1])[:, :, None, None] + cstate
        return new_state, yin + yintra

    _, ys = jax.lax.scan(body, jnp.zeros((B, nh, hd, hd + 1), jnp.float32),
                         (qs, ks_, vs, ls, iws))
    y = ys.transpose(1, 0, 2, 3, 4).reshape(B, S, nh, hd + 1)
    num, den = y[..., :hd], y[..., hd:]
    return (num / jnp.maximum(jnp.abs(den), 1.0)).astype(q.dtype)


def test_mlstm_masked_gap_repair_r13():
    """A forget bias of -10 over one 128-step chunk: the summed log forget
    gates pass -88, so exp(gap) above the diagonal overflows.  The
    reference's forward is finite and its gradient NaN; the port's forward
    equals it, and the port's gradient is finite and equals the repaired
    copy's."""
    q, k, v, logf, logi = _mlstm_inputs(B=1, S=128, nh=2, hd=16, seed=3, forget_bias=-10.0)
    assert float(-logf.sum(axis=1).min()) > 88
    w = np.random.default_rng(4).standard_normal((1, 128, 2, 16)).astype(np.float32)
    ins = tuple(jnp.asarray(a) for a in (q, k, v, logf, logi))

    def ref_loss(*a):
        return jnp.sum(jxlstm._mlstm_chunked(*a, 128)[0] * w)

    def fixed_loss(*a):
        return jnp.sum(_repaired_chunked(*a, 128) * w)

    jy = jxlstm._mlstm_chunked(*ins, 128)[0]
    assert np.isfinite(np.asarray(jy)).all()
    ref_grads = jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4))(*ins)
    assert np.isnan(np.asarray(ref_grads[3])).any()  # the reference's NaN, pinned
    fixed = jax.grad(fixed_loss, argnums=(0, 1, 2, 3, 4))(*ins)
    _close(_repaired_chunked(*ins, 128), jy)
    tins = [_t(a).requires_grad_(True) for a in (q, k, v, logf, logi)]
    y, _ = xlstm._mlstm_chunked(*tins, 128)
    _close(_np(y), jy)
    grads = torch.autograd.grad((y * _t(w)).sum(), tins)
    for g, want in zip(grads, fixed):
        assert torch.isfinite(g).all()
        _close(g.numpy(), want)


# ---------------------------------------------------------------------------
# the sub-layers: forward and decode, against each other and the reference
# ---------------------------------------------------------------------------

def _xlstm_sublayer(kind, seed=5):
    cfg = get_config("xlstm-350m").reduced()
    jcfg = jget_config("xlstm-350m").reduced()
    init = jxlstm.init_mlstm if kind == "mlstm" else jxlstm.init_slstm
    jp = init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    x = np.random.default_rng(seed).standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, jp, jax.tree.map(lambda a: _t(np.asarray(a)), jp), x


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_sublayer_forward_matches_reference(kind):
    """The sub-layer's prefill over 48 positions (the mLSTM at chunk 16:
    three chunks)."""
    cfg, jcfg, jp, params, x = _xlstm_sublayer(kind)
    if kind == "mlstm":
        want = jxlstm.mlstm_forward(jp, jnp.asarray(x), jcfg, chunk=16)
        got = xlstm.mlstm_forward(params, _t(x), cfg, chunk=16)
    else:
        want = jxlstm.slstm_forward(jp, jnp.asarray(x), jcfg)
        got = xlstm.slstm_forward(params, _t(x), cfg)
    _close(_np(got), want)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_decode_steps_match_forward_and_reference(kind):
    """48 decode steps from an empty cache, in place: each step's output
    against the reference's step and against the port's forward (the
    mLSTM's at chunk 16, so that its carried state crosses two chunk
    boundaries), and the final caches against the reference's."""
    cfg, jcfg, jp, params, x = _xlstm_sublayer(kind)
    mod_j, mod_t = jxlstm, xlstm
    if kind == "mlstm":
        jcache, cache = mod_j.init_mlstm_cache(jcfg, 2), mod_t.init_mlstm_cache(cfg, 2, "cpu")
        jstep, step = mod_j.mlstm_decode, mod_t.mlstm_decode
        full = mod_t.mlstm_forward(params, _t(x), cfg, chunk=16)
    else:
        jcache, cache = mod_j.init_slstm_cache(jcfg, 2), mod_t.init_slstm_cache(cfg, 2, "cpu")
        jstep, step = mod_j.slstm_decode, mod_t.slstm_decode
        full = mod_t.slstm_forward(params, _t(x), cfg)
    held = {k: v for k, v in cache.items()}
    outs = []
    for t in range(48):
        jout, jcache = jstep(jp, jcache, jnp.asarray(x[:, t:t + 1]), jcfg)
        out, cache2 = step(params, cache, _t(x[:, t:t + 1]), cfg)
        assert cache2 is cache and all(cache[k] is held[k] for k in held)  # in place
        _close(_np(out), jout)
        outs.append(out)
    _close(_np(torch.cat(outs, dim=1)), _np(full))
    for key in cache:
        _close(_np(cache[key]), jcache[key])
    if kind == "mlstm":
        # the stepped state is the chunked form's final state
        q, k, v, gates = xlstm._mlstm_inputs(params, _t(x), cfg)
        _, state = xlstm._mlstm_chunked(q, k, v, torch.nn.functional.logsigmoid(
            gates[:, :, 1]), gates[:, :, 0], 16)
        _close(_np(cache["C"]), _np(state))


def test_xlstm_pair_forward_and_decode_match_reference():
    """One pair block: its prefill over 256 positions (two mLSTM chunks) and
    256 decode steps, both against the reference's."""
    cfg, jcfg = get_config("xlstm-350m").reduced(), jget_config("xlstm-350m").reduced()
    jp = jblocks.init_xlstm_pair(jax.random.PRNGKey(2), jcfg, jnp.float32)
    params = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    x = np.random.default_rng(2).standard_normal((2, S_XLSTM, cfg.d_model)).astype(np.float32)
    want = jblocks.xlstm_pair_forward(jp, jnp.asarray(x), jcfg)
    got = blocks.xlstm_pair_forward(params, _t(x), cfg)
    _close(_np(got), want)
    cache = blocks.init_xlstm_pair_cache(cfg, 2, "cpu")
    steps = [blocks.xlstm_pair_decode(params, cache, _t(x[:, t:t + 1]), cfg)[0]
             for t in range(S_XLSTM)]
    _close(_np(torch.cat(steps, dim=1)), want)


# ---------------------------------------------------------------------------
# the slice: prefill, forward, decode, loss
# ---------------------------------------------------------------------------

def _port_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_forward_match_reference(arch):
    """B = 2, fp32, the plain attention route; xlstm-350m over 256 tokens
    (two mLSTM chunks), the others over 48 text tokens (internvl2-1b's 16
    patch positions ahead of them): logits at every position, patches
    included, and at the last, with no aux loss."""
    cfg, jm, tree, params, model = reference(arch)
    batch = make_batch(cfg, 2, _seq(arch))
    _close(_np(model.prefill(params, _port_batch(batch))), jm.prefill(tree, _jax_batch(batch)))
    logits, aux = model.forward(params, _port_batch(batch))
    jlogits, jaux = jm.forward(tree, _jax_batch(batch))
    width = _seq(arch) + (cfg.num_patches if cfg.frontend == "vision_stub" else 0)
    assert logits.shape == (2, width, cfg.vocab_size)
    _close(_np(logits), jlogits)
    assert float(aux) == float(jaux) == 0.0


def test_vision_patches_come_first_and_the_offset_counts_them():
    """``embed`` puts the projected patches (cast to the model's dtype)
    ahead of the token embeddings and returns their count; a model without
    the vision stub ignores ``patches``."""
    cfg, _, _, params, model = reference("internvl2-1b")
    batch = _port_batch(make_batch(cfg, 2, 8, seed=3))
    x, offset = model.embed(params, batch)
    assert offset == cfg.num_patches == 16 and x.shape == (2, 24, cfg.d_model)
    torch.testing.assert_close(x[:, :16], batch["patches"] @ params["vision_proj"],
                               rtol=0, atol=0)
    torch.testing.assert_close(x[:, 16:], params["embed"][batch["tokens"].long()],
                               rtol=0, atol=0)
    audio_cfg, _, _, audio_params, audio = reference("musicgen-medium")
    x, offset = audio.embed(audio_params, dict(batch, tokens=batch["tokens"]))
    assert offset == 0 and x.shape == (2, 8, audio_cfg.d_model)


def _decode_against_reference(cfg, jm, tree, params, model, steps, prime=None):
    """``steps`` decode steps after ``prime`` positions (0 without patches):
    a 16-token prompt then the reference's greedy tokens, both models fed
    the same token at every step; the logits at every step.  Returns the
    two final caches (the port's, the reference's)."""
    toks = make_batch(cfg, 2, PROMPT, seed=1)["tokens"]
    P = 0 if prime is None else prime[0].shape[1]
    cache, jcache = model.init_cache(2, P + steps), jm.init_cache(2, P + steps)
    if prime is not None:
        cache, jcache = prime[1](cache), prime[2](jcache)
    step = jax.jit(jm.decode_step)
    tok = toks[:, :1]
    for t in range(steps):
        jlogits, jcache = step(tree, jcache, jnp.asarray(tok), jnp.int32(P + t))
        logits, cache = model.decode_step(params, cache, _t(tok), P + t)
        _close(_np(logits), jlogits)
        tok = (toks[:, t + 1:t + 2] if t + 1 < PROMPT
               else np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32))
    return cache, jcache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """B = 2, 40 steps; internvl2-1b without patches (decode embeds tokens
    only, as the reference's does).  The caches after the last step cross
    the converter unchanged."""
    cfg, jm, tree, params, model = reference(arch)
    cache, jcache = _decode_against_reference(cfg, jm, tree, params, model, STEPS)
    back = lm_cache_to_numpy(cache)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jcache)):
        _close(got, want)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jcache))


def prime_with_patches(model, params, cache, patches):
    """Steps the projected patch embeddings through every attention block's
    decode at positions 0..P-1, filling ``cache`` in place (the reference
    has no patch-priming entry point; ``tests/test_decode.py`` primes its
    cache the same way)."""
    cfg = model.cfg
    with torch.inference_mode():
        pe = torch.matmul(torch.as_tensor(patches).to(model.dtype), params["vision_proj"])
        for p in range(pe.shape[1]):
            x = pe[:, p:p + 1]
            for lp, lc, w in zip(params["layers"], cache, layer_windows(cfg).tolist()):
                x, _ = blocks.attn_block_decode(lp, lc, x, p, cfg, w)
    return cache


def _jax_prime(jm, tree, jcache, patches):
    """``tests/test_decode.py``'s priming of the reference's cache."""
    from repro.models.model import layer_windows as jlayer_windows

    cfg = jm.cfg
    pe = jnp.einsum("bpv,vd->bpd", jnp.asarray(patches).astype(jm.dtype), tree["vision_proj"])
    windows = jnp.asarray(jlayer_windows(cfg))
    layers = jax.tree.map(jnp.asarray, tree["layers"])

    @jax.jit
    def embed_step(x_t, cache, pos):
        def body(xx, scanned):
            lp, lc, w = scanned
            return jblocks.attn_block_decode(lp, lc, xx, pos, cfg, w)

        _, new_cache = jax.lax.scan(body, x_t, (layers, cache, windows))
        return new_cache

    for p in range(pe.shape[1]):
        jcache = embed_step(pe[:, p:p + 1], jcache, jnp.int32(p))
    return jcache


def test_internvl_decode_after_priming_with_patches():
    """internvl2-1b: the cache primed with the 16 projected patch positions,
    then 24 text steps (40 positions in all), each step's logits against
    the reference's primed decode, and the text steps against the
    forward's text positions."""
    cfg, jm, tree, params, model = reference("internvl2-1b")
    patches = make_batch(cfg, 2, 1, seed=6)["patches"]
    P, T = cfg.num_patches, STEPS - cfg.num_patches
    toks = make_batch(cfg, 2, T, seed=7)["tokens"]
    cache = prime_with_patches(model, params, model.init_cache(2, P + T), patches)
    jcache = _jax_prime(jm, tree, jm.init_cache(2, P + T), patches)
    for got, want in zip(cache, [jax.tree.map(lambda a, i=i: a[i], jcache)
                                 for i in range(cfg.num_layers)]):
        for key in got:
            _close(_np(got[key]), want[key])
    step = jax.jit(jm.decode_step)
    steps = []
    for t in range(T):
        jlogits, jcache = step(tree, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(P + t))
        logits, cache = model.decode_step(params, cache, _t(toks[:, t:t + 1]), P + t)
        _close(_np(logits), jlogits)
        steps.append(logits)
    full, _ = model.forward(params, {"tokens": _t(toks), "patches": _t(patches)})
    _close(_np(torch.stack(steps, dim=1)), _np(full[:, P:]))


@pytest.mark.parametrize("arch", ARCHS)
def test_stepped_decode_equals_prefill(arch):
    """The port against itself: stepped decode from an empty cache against
    the forward of the same tokens at every position (xlstm-350m over 256
    positions: the decode recurrences against the chunked mLSTM across its
    chunk boundary)."""
    cfg, _, _, params, model = reference(arch)
    T = S_XLSTM if arch == "xlstm-350m" else STEPS
    toks = _t(make_batch(cfg, 2, T, seed=8)["tokens"])
    batch = {"tokens": toks}
    if cfg.frontend == "vision_stub":
        batch["patches"] = torch.zeros(2, 0, VISION_STUB_DIM)  # text only
    full, _ = model.forward(params, batch)
    cache = model.init_cache(2, T)
    steps = [model.decode_step(params, cache, toks[:, t:t + 1], t)[0] for t in range(T)]
    _close(_np(torch.stack(steps, dim=1)), _np(full))


def _port_grads(params, fn):
    leaves = [leaf.clone().requires_grad_(True) for _, leaf in ordered_leaves(params)]
    value = fn(with_leaves(params, leaves))
    return value, torch.cat([g.reshape(-1) for g in torch.autograd.grad(value, leaves)])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``Model.loss`` and its gradient against ``jax.value_and_grad`` of the
    reference's (internvl2-1b's batch with its patches: the loss scores the
    text positions only, and ``vision_proj`` gets a gradient), and the
    per-example rows.  xlstm-350m over 256 positions: the gradient through
    both chunks and the sLSTM's 256 steps."""
    cfg, jm, tree, params, model = reference(arch)
    batch = make_batch(cfg, 2, S_XLSTM if arch == "xlstm-350m" else 16, seed=4, labels=True)
    jb = _jax_batch(batch)
    (want, jparts), jgrad = jax.value_and_grad(lambda p: jm.loss(p, jb), has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    tb = _port_batch(batch)
    got, grad = _port_grads(params, lambda p: model.loss(p, tb)[0])
    _close(float(got.detach()), float(want))
    _close(grad.numpy(), np.asarray(jflatten(jgrad)))
    assert torch.isfinite(grad).all()
    rows, aux = model.loss_per_example(params, tb)
    jrows, jaux = jm.loss_per_example(jax.tree.map(jnp.asarray, tree), jb)
    _close(_np(rows), jrows)
    assert float(aux) == float(jaux) == 0.0
    if cfg.frontend == "vision_stub":
        assert float(np.abs(np.asarray(jgrad["vision_proj"])).max()) > 0


def test_xlstm_cache_converters_round_trip():
    """The reference's stacked xLSTM cache (nested one level deeper than
    the attention caches) into the port's per-pair dicts and back,
    unchanged; the port's decode resumes from the converted cache as the
    reference does."""
    cfg, jm, tree, params, model = reference("xlstm-350m")
    toks = make_batch(cfg, 2, 12, seed=9)["tokens"]
    jcache = jm.init_cache(2, 12)
    step = jax.jit(jm.decode_step)
    for t in range(6):
        _, jcache = step(tree, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
    jcache = jax.tree.map(np.asarray, jcache)
    cache = lm_cache_from_jax(jcache, cfg, "cpu")
    assert len(cache) == 2 and set(cache[0]) == {"slstm", "mlstm"}
    assert set(cache[0]["slstm"]) == set("hcnm") and set(cache[0]["mlstm"]) == {"C"}
    assert cache[1]["mlstm"]["C"].shape == (2, 4, 128, 129)
    back = lm_cache_to_numpy(cache)
    assert jax.tree.structure(back) == jax.tree.structure(jcache)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jcache)):
        np.testing.assert_array_equal(got, want)
    for t in range(6, 12):
        jlogits, jcache = step(tree, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        logits, cache = model.decode_step(params, cache, _t(toks[:, t:t + 1]), t)
        _close(_np(logits), jlogits)
    with pytest.raises(ValueError, match="rows"):
        lm_cache_from_jax(jax.tree.map(np.asarray, jm.init_cache(2, 4)),
                          cfg.reduced(num_layers=2), "cpu")


def test_xlstm_client_update_matches_reference():
    """One client's ClientUpdate through ``LMClientModel`` on a reduced
    xlstm-350m (one pair, d_model 64): E = 2 epochs of batch 4 over 8
    sequences of 12 tokens, masked."""
    over = dict(num_layers=2, d_model=64, vocab_size=128)
    cfg, _, tree, params, _ = reference("xlstm-350m", tuple(over.items()))
    jmodel = JLMClientModel(jget_config("xlstm-350m").reduced(**over))
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab_size, (8, 12)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (8, 12)).astype(np.int32)
    mask = np.arange(8) < 7
    want = jmodel.client_update(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
        lr=0.05, batch_size=4, epochs=2, sample_mask=jnp.asarray(mask))
    got = LMClientModel(cfg, device="cpu").client_update(
        params, {"tokens": _t(tok[None]), "labels": _t(lab[None])}, lr=0.05, batch_size=4,
        epochs=2, sample_mask=_t(mask[None]))
    _close(got[0].numpy(), np.asarray(jflatten(want)), 2e-4)
    assert (got[0] - flatten(params)).abs().max() > 1e-3
