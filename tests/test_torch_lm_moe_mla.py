"""The mixture-of-experts and multi-head latent attention configs in the
port against the reference, on the CPU: ``qwen2-moe-a2.7b`` (routed and
shared experts), ``arctic-480b`` (a dense residual FFN beside the experts)
and ``minicpm3-4b`` (MLA), at ``reduced()``, from the reference's params
(``convert.lm_params_from_jax``).

Routing is discontinuous, so it is held exactly: the same router
probabilities in give bit-equal expert indices, slots, gates and dispatch
tensors out, dropless, with capacity drops, and with pad tokens (a token
count that is not a whole number of groups).  ``moe_forward`` is held
within tolerance in both dispatch modes; a token whose kept experts differ
between the two sides must sit within 1e-5 of a tie between its k-th and
(k+1)-th probability, and is left out of the comparison.  Then MLA's
expanded prefill on the plain route and on kernel 8's padded-v layout,
``Model.prefill`` / ``forward`` with the aux loss, 40 decode steps,
``Model.loss`` and its gradients against ``jax.grad``, one client update,
and the converters.  Everything runs in fp32; the tolerance is 1e-4 (the
fp32 LM band of ``tests/test_torch_lm_model.py``: the MoE's softmax,
normalised gates and aux loss sum in another order on each side).
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
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models.model import Model as JModel
from repro_torch.configs import PORTED, get_config
from repro_torch.convert import lm_cache_from_jax, lm_cache_to_numpy, lm_params_from_jax
from repro_torch.core.engine import flatten, ordered_leaves, with_leaves
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention as flash_wrapper
from repro_torch.models import attention, blocks, moe
from repro_torch.models.model import LMClientModel, Model, decode_cache_len

TOL = 1e-4
MARGIN = 1e-5  # a token whose experts differ must be this close to a tie
ARCHS = ("qwen2-moe-a2.7b", "arctic-480b", "minicpm3-4b")
MOE_ARCHS = ("qwen2-moe-a2.7b", "arctic-480b")
S, PROMPT, STEPS = 48, 16, 40


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


@functools.lru_cache(maxsize=None)
def reference(arch, over_items=()):
    """(port config, reference model, its params as numpy leaves, the port's
    params converted from them, the port's CPU model)."""
    over = dict(over_items)
    jcfg = jget_config(arch).reduced(**over)
    jm = JModel(jcfg)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    cfg = get_config(arch).reduced(**over)
    return cfg, jm, tree, lm_params_from_jax(tree, cfg, "cpu"), Model(cfg, device="cpu")


def tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_by_field(arch):
    assert arch in PORTED
    cfg, jcfg = get_config(arch), jget_config(arch)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    for over in ({}, dict(num_layers=4), dict(moe_capacity_factor=0.5),
                 dict(moe_dispatch="scatter")):
        assert (dataclasses.asdict(cfg.reduced(**over))
                == dataclasses.asdict(jcfg.reduced(**over)))
    if arch == "minicpm3-4b":
        assert cfg.attention == "mla" and cfg.qk_nope_dim + cfg.qk_rope_dim == 96
        assert cfg.v_head_dim == 64 and not cfg.num_experts
    else:
        assert cfg.num_experts and cfg.moe_dispatch == "onehot"
        assert cfg.dense_residual == (arch == "arctic-480b")
        assert bool(cfg.num_shared_experts) == (arch == "qwen2-moe-a2.7b")


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
    assert Model(cfg, device="cpu").kind == "attn"


# ---------------------------------------------------------------------------
# routing, bit for bit
# ---------------------------------------------------------------------------

def _router_inputs(cfg, N, seed):
    """(xt (G, group, d) padded as moe_forward pads, router (d, E)) as numpy
    fp32, and the reference's probabilities from them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, cfg.d_model)).astype(np.float32)
    router = (rng.standard_normal((cfg.d_model, cfg.num_experts))
              / np.sqrt(cfg.d_model)).astype(np.float32)
    group = min(moe.MAX_GROUP, N)
    pad = (-N) % group
    xt = np.concatenate([x, np.zeros((pad, cfg.d_model), np.float32)]).reshape(
        -1, group, cfg.d_model)
    logits = jnp.einsum("gnd,de->gne", jnp.asarray(xt), jnp.asarray(router))
    return xt, router, np.asarray(jax.nn.softmax(logits, axis=-1))


ROUTE_CASES = [  # (arch, tokens, capacity factor)
    ("qwen2-moe-a2.7b", 96, 16.0),   # dropless
    ("qwen2-moe-a2.7b", 96, 0.5),    # drops
    ("arctic-480b", 96, 0.5),
    ("qwen2-moe-a2.7b", 1200, 1.25),  # 848 pad tokens in the second group
    ("qwen2-moe-a2.7b", 2048, 0.25),  # two whole groups, many drops
]
ROUTE_IDS = ["dropless", "drops", "arctic-drops", "pad-tokens", "two-groups"]


@pytest.mark.parametrize("arch,N,factor", ROUTE_CASES, ids=ROUTE_IDS)
def test_routing_is_bit_equal_to_the_reference(arch, N, factor):
    """``_route_indices`` and ``_route_topk`` on the reference's own probs:
    idx, pos, gate and the dispatch tensor identical bit for bit.  With pad
    tokens their probabilities are exactly uniform, a tie that both sides
    break to the first expert."""
    cfg = get_config(arch).reduced(moe_capacity_factor=factor)
    _, _, probs = _router_inputs(cfg, N, seed=N)
    group, k, E = probs.shape[1], cfg.num_experts_per_tok, cfg.num_experts
    capacity = max(int(group * k * factor / E), 4)
    jidx, jpos, jgate = (np.asarray(a) for a in jmoe._route_indices(jnp.asarray(probs), k,
                                                                     capacity))
    idx, pos, gate = moe._route_indices(_t(probs), k, capacity)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    np.testing.assert_array_equal(gate.numpy(), jgate)
    jdisp = np.asarray(jmoe._route_topk(jnp.asarray(probs), k, capacity))
    disp = moe._route_topk(_t(probs), k, capacity)
    assert disp.dtype == torch.float32 and disp.shape == jdisp.shape
    np.testing.assert_array_equal(disp.numpy(), jdisp)
    # only the dropless case drops nothing: the pad tokens, all on experts
    # 0..k-1, fill those experts past capacity
    assert (int((jgate == 0).sum()) == 0) == (factor >= 16.0)
    if N % group:
        # the pad tokens pick experts 0..k-1 in order
        pad_idx = idx.numpy()[-1, N % group:]
        np.testing.assert_array_equal(pad_idx, np.broadcast_to(np.arange(k), pad_idx.shape))


MOE_CASES = [  # (arch, B, S, overrides)
    ("qwen2-moe-a2.7b", 2, S, {}),
    ("qwen2-moe-a2.7b", 2, S, dict(moe_capacity_factor=0.5)),
    ("arctic-480b", 2, S, dict(moe_capacity_factor=0.5)),
    ("qwen2-moe-a2.7b", 3, 400, {}),  # 1,200 tokens: a padded second group
]
MOE_IDS = ["qwen2", "qwen2-drops", "arctic-drops", "qwen2-pad-tokens"]


@pytest.mark.parametrize("dispatch", ["onehot", "scatter"])
@pytest.mark.parametrize("arch,B,T,over", MOE_CASES, ids=MOE_IDS)
def test_moe_forward_matches_reference(arch, B, T, over, dispatch):
    """The MoE sub-layer on the reference's params, each dispatch mode
    against the reference's same mode: the output within TOL on every
    token whose kept experts agree, a route flip only within MARGIN of a
    tie, and the aux loss within TOL."""
    cfg = get_config(arch).reduced(moe_dispatch=dispatch, **over)
    jcfg = jget_config(arch).reduced(moe_dispatch=dispatch, **over)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32)
    params = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    x = np.random.default_rng(5).standard_normal((B, T, cfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    out, aux = moe.moe_forward(params, _t(x), cfg)
    assert out.shape == (B, T, cfg.d_model) and out.dtype == torch.float32
    _close(float(aux), float(jaux))
    assert float(aux) > 0

    # the two sides' routes, each from its own probabilities
    N, k, E = B * T, cfg.num_experts_per_tok, cfg.num_experts
    xt, _, capacity = moe.route_inputs(params, _t(x), cfg)
    jprobs = np.asarray(jax.nn.softmax(jnp.einsum("gnd,de->gne", jnp.asarray(xt.numpy()),
                                                  jp["router"]), axis=-1))
    ji, _, jg = jmoe._route_indices(jnp.asarray(jprobs), k, capacity)
    theirs = moe.kept_picks(_t(ji).long(), _t(jg), E).reshape(-1, E)[:N] > 0
    ours, _ = moe.kept_experts(params, _t(x), cfg)
    differ = (theirs != ours).any(-1).numpy()
    margin = moe.route_margin(_t(jprobs), k).reshape(-1)[:N].numpy()
    assert (margin[differ] < MARGIN).all(), (margin[differ], differ.sum())
    same = ~differ.reshape(B, T)
    _close(out.numpy()[same], np.asarray(jout)[same])


def test_moe_dispatch_modes_agree():
    """The two dispatch modes are one function: the same output and aux
    loss on the same params, with drops."""
    cfg = get_config("qwen2-moe-a2.7b").reduced(moe_capacity_factor=0.5)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x = torch.randn(2, S, cfg.d_model, generator=torch.Generator().manual_seed(1))
    a, aux_a = moe.moe_forward(params, x, cfg)
    b, aux_b = moe.moe_forward(params, x, dataclasses.replace(cfg, moe_dispatch="scatter"))
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux_a, aux_b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_inputs(over=()):
    cfg = get_config("minicpm3-4b").reduced(**dict(over))
    jcfg = jget_config("minicpm3-4b").reduced(**dict(over))
    jp = jattn.init_mla(jax.random.PRNGKey(4), jcfg, jnp.float32)
    params = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    x = np.random.default_rng(6).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, jp, params, x


@pytest.mark.parametrize("window", [0, 20])
def test_mla_forward_plain_route_matches_reference(window):
    """The expanded form on the plain route (``_attend_chunked`` with v at
    its own head dim) against the reference's ``mla_forward``."""
    cfg, jcfg, jp, params, x = _mla_inputs()
    pos = np.arange(S, dtype=np.int32)
    want = jattn.mla_forward(jp, jnp.asarray(x), jnp.asarray(pos), jcfg, window)
    got = attention.mla_forward(params, _t(x), torch.arange(S), cfg, window, "einsum")
    _close(_np(got), want, 1e-5)


@pytest.mark.parametrize("window", [0, 20])
def test_mla_kernel_route_pads_v_for_kernel_8(monkeypatch, window):
    """The kernel route's layout on the CPU: ``mla_forward`` hands kernel
    8's wrapper (here on CPU tensors, so its plain version) v zero-padded
    to q's head dim, one head dim for q, k and v, and keeps the first
    ``v_head_dim`` columns; the padded output columns are exactly 0 and
    the result is the reference's."""
    cfg, jcfg, jp, params, x = _mla_inputs()
    seen = []

    def kernel(q, k, v, *, causal, window, impl):
        assert impl == "kernel"
        out = flash_wrapper(q, k, v, causal=causal, window=window)
        seen.append((q.shape, k.shape, v.shape, out))
        return out

    monkeypatch.setattr(ops, "resolve_impl", lambda name, kind, device: "kernel")
    monkeypatch.setattr(ops, "flash_attention", kernel)
    got = attention.mla_forward(params, _t(x), torch.arange(S), cfg, window)
    (qs, ks, vs, out), = seen
    dqk, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    assert qs == ks == vs == (2, S, cfg.num_heads, dqk) and dv < dqk
    assert torch.equal(out[..., dv:], torch.zeros_like(out[..., dv:]))
    pos = np.arange(S, dtype=np.int32)
    _close(_np(got), jattn.mla_forward(jp, jnp.asarray(x), jnp.asarray(pos), jcfg, window),
           1e-5)


def test_mla_padded_v_equals_attention_at_v_head_dim():
    """Kernel 8's plain version on v padded 64 -> 96 (minicpm3-4b's head
    dims, 40 heads cut to 4), sliced back, against the reference's
    ``_attend_chunked`` on the unpadded v: the zero columns change
    nothing."""
    rng = np.random.default_rng(8)
    q, k = (rng.standard_normal((1, 64, 4, 96)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((1, 64, 4, 64)).astype(np.float32)
    pos = jnp.arange(64, dtype=jnp.int32)
    want = jattn._attend_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, pos, 0)
    vp = torch.nn.functional.pad(_t(v), (0, 32))
    got = flash_wrapper(_t(q), _t(k), vp, causal=True, window=0)
    assert torch.equal(got[..., 64:], torch.zeros_like(got[..., 64:]))
    _close(_np(got[..., :64]), want, 1e-5)


def test_mla_decode_matches_reference_and_its_own_prefill():
    """The absorbed decode over the (ckv, krope) cache, 24 steps through a
    16-slot ring (window 16, so it wraps), against the reference's decode
    at every step, and against the expanded prefill at the same window."""
    cfg, jcfg, jp, params, x = _mla_inputs()
    T, clen, window = 24, 16, 16
    cache = attention.init_mla_cache(cfg, 2, clen, torch.float32, "cpu")
    jcache = jattn.init_mla_cache(jcfg, 2, clen, jnp.float32)
    assert set(cache) == {"ckv", "krope"}
    steps = []
    for t in range(T):
        jout, jcache = jattn.mla_decode(jp, jcache, jnp.asarray(x[:, t:t + 1]), jnp.int32(t),
                                        jcfg, window)
        out, cache = attention.mla_decode(params, cache, _t(x[:, t:t + 1]), t, cfg, window)
        _close(_np(out), jout, 1e-5)
        steps.append(out)
    for key in ("ckv", "krope"):
        _close(_np(cache[key]), jcache[key], 1e-5)
    full = attention.mla_forward(params, _t(x[:, :T]), torch.arange(T), cfg, window, "einsum")
    _close(_np(torch.cat(steps, dim=1)), _np(full), 1e-5)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def test_dense_block_is_gqa_then_ffn_with_no_aux():
    """A dense block returns no aux loss and the same bits as its two
    sub-layers added in turn."""
    from repro_torch.models.ffn import ffn_forward
    from repro_torch.models.layers import rms_norm

    cfg = get_config("tinyllama-1.1b").reduced()
    p = blocks.init_attn_block(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    assert set(p) == {"ln1", "ln2", "attn", "ffn"}
    x = torch.randn(2, S, cfg.d_model, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(S)
    got, aux = blocks.attn_block_forward(p, x, pos, cfg, 0, "einsum")
    h = x + attention.gqa_forward(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), pos, cfg,
                                  0, "einsum")
    want = h + ffn_forward(p["ffn"], rms_norm(h, p["ln2"], cfg.norm_eps), cfg.act)
    assert aux is None and torch.equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_block_trees_match_the_reference(arch):
    """The port's per-layer tree is the reference's: the same keys and
    shapes, MLA or GQA, ``moe`` with arctic's ``ffn`` beside it, and the
    fp32 router and shared gate in a bf16 model."""
    cfg = get_config(arch).reduced(dtype="bfloat16")
    jcfg = jget_config(arch).reduced(dtype="bfloat16")
    jtree = jax.eval_shape(lambda k: JModel(jcfg).init_params(k), jax.random.PRNGKey(0))
    ours = Model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    jl = jax.tree.map(lambda a: (a.shape[1:], str(a.dtype)), jtree["layers"])
    tl = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), ours["layers"][0])
    assert tl == jl
    if cfg.num_experts:
        moe_p = ours["layers"][0]["moe"]
        assert moe_p["router"].dtype == torch.float32
        assert ("ffn" in ours["layers"][0]) == cfg.dense_residual
        assert ("shared_gate" in moe_p) == bool(cfg.num_shared_experts)


# ---------------------------------------------------------------------------
# the slice: prefill, forward, decode, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_forward_match_reference(arch):
    """B = 2, S = 48, fp32, the plain attention route; logits at every
    position and at the last, and the aux loss summed over the layers."""
    cfg, jm, tree, params, model = reference(arch)
    toks = tokens(cfg, 2, S)
    batch, jbatch = {"tokens": _t(toks)}, {"tokens": jnp.asarray(toks)}
    _close(_np(model.prefill(params, batch)), jm.prefill(tree, jbatch))
    logits, aux = model.forward(params, batch)
    jlogits, jaux = jm.forward(tree, jbatch)
    assert logits.shape == (2, S, cfg.vocab_size)
    _close(_np(logits), jlogits)
    _close(float(aux), float(jaux))
    assert (float(aux) > 0) == bool(cfg.num_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """B = 2: a 16-token prompt then 24 of the reference's greedy tokens, 40
    steps, both models fed the same token at every step; logits at every
    step.  Both sides drop alike (one token a sequence per step, a group
    of 2), so no capacity override is needed."""
    cfg, jm, tree, params, model = reference(arch)
    toks = tokens(cfg, 2, PROMPT, seed=1)
    cache, jcache = model.init_cache(2, STEPS), jm.init_cache(2, STEPS)
    assert decode_cache_len(cfg, STEPS) == STEPS
    step = jax.jit(jm.decode_step)
    tok = toks[:, :1]
    for t in range(STEPS):
        jlogits, jcache = step(tree, jcache, jnp.asarray(tok), jnp.int32(t))
        logits, cache = model.decode_step(params, cache, _t(tok), t)
        _close(_np(logits), jlogits)
        tok = (toks[:, t + 1:t + 2] if t + 1 < PROMPT
               else np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32))
    # the converters carry the cache across, both ways
    _close(np.concatenate([lm_cache_to_numpy(cache)[k].ravel() for k in sorted(cache[0])]),
           np.concatenate([np.asarray(jcache[k]).ravel() for k in sorted(jcache)]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_equals_prefill_when_dropless(arch):
    """Stepped decode against the prefill of the same prompt at every
    position, with ``moe_capacity_factor=16`` (the reference's own decode
    test): prefill groups the whole batch and may drop, decode never does."""
    cfg, _, tree, _, _ = reference(arch)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=16.0)
    model = Model(cfg, device="cpu")
    params = lm_params_from_jax(tree, cfg, "cpu")
    toks = tokens(cfg, 2, 24, seed=2)
    full, _ = model.forward(params, {"tokens": _t(toks)})
    cache = model.init_cache(2, 24)
    for t in range(24):
        logits, cache = model.decode_step(params, cache, _t(toks[:, t:t + 1]), t)
        _close(_np(logits), _np(full[:, t]))


@pytest.mark.parametrize("arch", ["minicpm3-4b"])
def test_mla_cache_converters_round_trip(arch):
    """The reference's stacked (ckv, krope) cache into the port's per-layer
    dicts and back, unchanged."""
    cfg, jm, _, _, _ = reference(arch)
    jcache = jm.init_cache(2, 12)
    rng = np.random.default_rng(9)
    jcache = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in jcache.items()}
    cache = lm_cache_from_jax(jcache, cfg, "cpu")
    assert len(cache) == cfg.num_layers and set(cache[0]) == {"ckv", "krope"}
    assert cache[0]["ckv"].shape == (2, 12, cfg.kv_lora_rank)
    back = lm_cache_to_numpy(cache)
    for k in jcache:
        np.testing.assert_array_equal(back[k], jcache[k])


def test_params_converter_keeps_the_moe_router_fp32():
    """``lm_params_from_jax`` on a bf16 MoE tree with arctic's ``ffn`` and
    qwen2's shared gate: the router and shared gate stay fp32, every
    other weight casts, and the leaves keep the reference's values."""
    for arch in MOE_ARCHS:
        jcfg = jget_config(arch).reduced(dtype="bfloat16")
        tree = jax.tree.map(np.asarray, JModel(jcfg).init_params(jax.random.PRNGKey(1)))
        cfg = get_config(arch).reduced(dtype="bfloat16")
        params = lm_params_from_jax(tree, cfg, "cpu", dtype=torch.bfloat16)
        lp = params["layers"][1]
        assert lp["moe"]["router"].dtype == torch.float32
        assert lp["moe"]["w_gate"].dtype == torch.bfloat16
        if cfg.num_shared_experts:
            assert lp["moe"]["shared_gate"].dtype == torch.float32
            assert lp["moe"]["shared"]["w_up"].dtype == torch.bfloat16
        if cfg.dense_residual:
            assert lp["ffn"]["w_down"].dtype == torch.bfloat16
        np.testing.assert_array_equal(lp["moe"]["router"].numpy(),
                                      tree["layers"]["moe"]["router"][1])
        want = tree["layers"]["moe"]["w_up"][1].astype(np.float32)
        np.testing.assert_array_equal(_np(lp["moe"]["w_up"]), want)


def _port_grads(params, fn):
    leaves = [leaf.clone().requires_grad_(True) for _, leaf in ordered_leaves(params)]
    value = fn(with_leaves(params, leaves))
    return value, torch.cat([g.reshape(-1) for g in torch.autograd.grad(value, leaves)])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``Model.loss`` (the NLL plus the summed aux loss) and its gradient
    against ``jax.value_and_grad`` of the reference's, and the per-example
    rows with their aux."""
    cfg, jm, tree, params, model = reference(arch)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, jparts), jgrad = jax.value_and_grad(lambda p: jm.loss(p, jb), has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    tb = {k: _t(v) for k, v in batch.items()}
    got, grad = _port_grads(params, lambda p: model.loss(p, tb)[0])
    _close(float(got.detach()), float(want))
    _, parts = model.loss(params, tb)
    _close(float(parts["aux"]), float(jparts["aux"]))
    assert (float(parts["aux"]) > 0) == bool(cfg.num_experts)
    _close(grad.numpy(), np.asarray(jflatten(jgrad)))
    rows, aux = model.loss_per_example(params, tb)
    jrows, jaux = jm.loss_per_example(jax.tree.map(jnp.asarray, tree), jb)
    _close(_np(rows), jrows)
    _close(float(aux), float(jaux))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_client_update_matches_reference(arch):
    """One client's ClientUpdate through ``LMClientModel`` with the aux
    term in its loss: E = 2 epochs of batch 4 over 8 sequences, masked."""
    over = dict(num_layers=1, d_model=64, d_ff=128, vocab_size=128, moe_d_ff=64)
    cfg, _, tree, params, _ = reference(arch, tuple(over.items()))
    jmodel = JLMClientModel(jget_config(arch).reduced(**over))
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
