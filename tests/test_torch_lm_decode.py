"""The port's LM decode (``Model.init_cache`` / ``decode_step``, ``gqa_decode``,
``mamba2_decode``) against the reference's, on the CPU, from the same params
(``convert.lm_params_from_jax``) and, where a run starts mid-sequence or
ends in a cache comparison, the same caches (``convert.lm_cache_from_jax`` /
``lm_cache_to_numpy``).

fp32 on the plain route; atol = rtol = 1e-4, the band of
``tests/test_torch_lm_model.py``.  A block from the same input and cache
differs from the reference's by ~2e-6 to 1e-5 on outputs of ~3 (another
``exp`` and other summation orders), but four random-init zamba layers
amplify that (one Mamba2 layer 15-fold on one step), so over whole steps
the 4-layer zamba lands 1.0-2.2 x the band away on single steps of three
of four seeds tried (ROADMAP R11).  That configuration is therefore held
block by block at every step; whole steps run on the 2-layer reduction
(one shared-block application; at most 0.44 of the band over six seeds)
and on tinyllama (at most 0.04).  The decode path reaches no kernel on any
device (ROADMAP R4), so there is no kernel route to hold here; the card
runs it in ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 9b.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models.model import Model as JModel
from repro.models.model import decode_cache_len as jdecode_cache_len
from repro_torch.configs import get_config
from repro_torch.convert import lm_cache_from_jax, lm_cache_to_numpy, lm_params_from_jax
from repro_torch.models import attention, blocks, ssm
from repro_torch.models.layers import rms_norm
from repro_torch.models.model import Model, decode_cache_len

TOL = 1e-4
PROMPT, MORE = 16, 8
ZAMBA4 = ("zamba2-7b", dict(num_layers=4))  # two shared-block applications
TINY = [
    ("tinyllama-1.1b", {}),                        # GQA: 4 heads over 2 kv heads
    ("tinyllama-1.1b", dict(sliding_window=8)),    # an 8-slot ring, wraps twice
    ("tinyllama-1.1b", dict(global_every=2, local_window=8)),  # per-layer windows
]
TINY_IDS = ["tinyllama-1.1b", "tinyllama-ring8", "tinyllama-local-global"]
CASES, IDS = [ZAMBA4] + TINY, ["zamba2-7b"] + TINY_IDS
# whole steps against the reference: zamba2-7b's 2-layer reduction (R11)
WHOLE, WHOLE_IDS = [("zamba2-7b", {})] + TINY, ["zamba2-7b-2layers"] + TINY_IDS


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def reference(arch, over, seed=0, dtype=None):
    """(port config, reference model, reference params as numpy leaves)."""
    if dtype:
        over = dict(over, dtype=dtype)
    jcfg = jget_config(arch).reduced(**over)
    jm = JModel(jcfg)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    return get_config(arch).reduced(**over), jm, tree


def prompt(cfg, B=2, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)


def _assert_caches_close(cache, jcache):
    got, want = lm_cache_to_numpy(cache), jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        _close(g, w)


# ---------------------------------------------------------------------------
# the slice: Model.decode_step from the reference's params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,over", WHOLE, ids=WHOLE_IDS)
def test_decode_steps_match_reference(arch, over):
    """B = 2: the prompt's 16 tokens, then 8 steps on the reference's greedy
    tokens, both models fed the same token at every step; logits compared
    at every step, the caches after the last."""
    cfg, jm, tree = reference(arch, over)
    params = lm_params_from_jax(tree, cfg, "cpu")
    model = Model(cfg, device="cpu")
    toks = prompt(cfg)
    total = PROMPT + MORE
    cache, jcache = model.init_cache(2, total), jm.init_cache(2, total)
    step = jax.jit(jm.decode_step)
    tok = toks[:, :1]
    for t in range(total):
        jlogits, jcache = step(tree, jcache, jnp.asarray(tok), jnp.int32(t))
        logits, cache = model.decode_step(params, cache, torch.as_tensor(tok), t)
        assert logits.shape == (2, cfg.vocab_size)
        _close(_np(logits), jlogits)
        tok = (toks[:, t + 1:t + 2] if t + 1 < PROMPT
               else np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32))
    _assert_caches_close(cache, jcache)


@pytest.mark.parametrize("arch,over", WHOLE, ids=WHOLE_IDS)
def test_decode_resumes_from_the_reference_cache(arch, over):
    """The reference steps the first 10 tokens; its cache crosses through
    ``lm_cache_from_jax`` and both models step the rest of the prompt from
    it (past the 8-slot ring's first wrap)."""
    cfg, jm, tree = reference(arch, over, seed=1)
    params = lm_params_from_jax(tree, cfg, "cpu")
    model = Model(cfg, device="cpu")
    toks = prompt(cfg, seed=1)
    step = jax.jit(jm.decode_step)
    jcache = jm.init_cache(2, PROMPT)
    for t in range(10):
        _, jcache = step(tree, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
    cache = lm_cache_from_jax(jax.tree.map(np.asarray, jcache), cfg, "cpu")
    for t in range(10, PROMPT):
        jlogits, jcache = step(tree, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        logits, cache = model.decode_step(params, cache, torch.as_tensor(toks[:, t:t + 1]), t)
        _close(_np(logits), jlogits)
    _assert_caches_close(cache, jcache)


def test_zamba_decode_block_by_block_matches_reference():
    """zamba2-7b ``reduced(num_layers=4)``, the prompt's 16 tokens then 8
    of the reference's greedy tokens: at every step each block application
    (four Mamba2 layers, the shared block after the second and fourth)
    runs on both sides from the reference's input and cache slot, and its
    output and cache update must agree; so must the logits from the
    reference's last hidden state."""
    cfg, jm, tree = reference(*ZAMBA4)
    jcfg, every = jm.cfg, cfg.shared_attn_every
    params = lm_params_from_jax(tree, cfg, "cpu")
    model = Model(cfg, device="cpu")
    jshared = jax.tree.map(jnp.asarray, tree["shared_attn"])
    toks = prompt(cfg)
    total = PROMPT + MORE
    jcache = jax.tree.map(np.asarray, jm.init_cache(2, total))

    def at(tree_, i):
        return jax.tree.map(lambda a: jnp.asarray(a[i]), tree_)

    def both(jfn, fn, jslot, slot, jx):
        jy, jnew = jfn(jslot, jx)
        y, new = fn(slot, torch.as_tensor(np.array(jx)))
        _close(_np(y), jy)
        for k in new:
            _close(_np(new[k]), jnew[k])
        return jy, jax.tree.map(np.asarray, jnew)

    tok = toks[:, :1]
    for t in range(total):
        cache = lm_cache_from_jax(jcache, cfg, "cpu")
        jx = jnp.take(jnp.asarray(tree["embed"]), jnp.asarray(tok), axis=0)
        mamba, attn_ = [], []
        for i, lp in enumerate(params["layers"]):
            jx, new = both(
                lambda c, x: jblocks.mamba_block_decode(at(tree["layers"], i), c, x, jcfg),
                lambda c, x: blocks.mamba_block_decode(lp, c, x, cfg),
                at(jcache["mamba"], i), cache["mamba"][i], jx)
            mamba.append(new)
            if (i + 1) % every == 0:
                j = (i + 1) // every - 1
                jx, new = both(
                    lambda c, x: jblocks.attn_block_decode(jshared, c, x, jnp.int32(t), jcfg, 0),
                    lambda c, x: blocks.attn_block_decode(params["shared_attn"], c, x, t, cfg, 0),
                    at(jcache["attn"], j), cache["attn"][j], jx)
                attn_.append(new)
        jcache = {"mamba": jax.tree.map(lambda *a: np.stack(a), *mamba),
                  "attn": jax.tree.map(lambda *a: np.stack(a), *attn_)}
        h = jx[:, 0]
        want = jm.logits(tree, jlayers.rms_norm(h, jnp.asarray(tree["final_norm"]),
                                                cfg.norm_eps))
        got = model.logits(params, rms_norm(torch.as_tensor(np.array(h)),
                                            params["final_norm"], cfg.norm_eps))
        _close(_np(got), want)
        tok = (toks[:, t + 1:t + 2] if t + 1 < PROMPT
               else np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32))


@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_stepped_decode_equals_prefill(arch, over):
    """Stepping the prompt through the cache lands on ``prefill``'s logits
    at the last position (both the port's; the 16 positions are one SSD
    chunk of the reduced zamba)."""
    cfg, _, tree = reference(arch, over)
    params = lm_params_from_jax(tree, cfg, "cpu")
    model = Model(cfg, device="cpu")
    toks = torch.as_tensor(prompt(cfg))
    cache = model.init_cache(2, PROMPT)
    for t in range(PROMPT):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
    _close(_np(logits), _np(model.prefill(params, {"tokens": toks})))


def test_decode_step_updates_the_cache_in_place():
    """``decode_step`` returns the cache object it was given, each leaf the
    same storage, and the step wrote into it."""
    cfg = get_config("zamba2-7b").reduced()
    model = Model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 8)
    leaves = [c[k] for group in cache.values() for c in group for k in c]
    ptrs = [t.data_ptr() for t in leaves]
    out_logits, out = model.decode_step(params, cache, torch.ones(2, 1, dtype=torch.long), 0)
    assert out is cache
    assert [c[k].data_ptr() for group in out.values() for c in group for k in c] == ptrs
    assert all(bool(t.ne(0).any()) for t in leaves)
    assert torch.isfinite(out_logits).all()


# ---------------------------------------------------------------------------
# cache layout
# ---------------------------------------------------------------------------

def _meta(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), tree)


@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_init_cache_shapes_and_dtypes_equal_the_reference(arch, over):
    """bf16, so the per-leaf dtypes show: KV and conv caches bf16, the SSM
    state fp32.  Two bf16 steps keep them, and ``decode_cache_len`` is the
    reference's at several lengths."""
    cfg, jm, _ = reference(arch, over, dtype="bfloat16")
    model = Model(cfg, device="cpu")
    cache = model.init_cache(3, 40)
    want = _meta(jax.eval_shape(lambda: jm.init_cache(3, 40)))
    assert _port_meta(cache) == want
    params = model.init_params(torch.Generator().manual_seed(0))
    for t in range(2):
        logits, cache = model.decode_step(params, cache, torch.zeros(3, 1, dtype=torch.long), t)
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits).all()
    assert _port_meta(cache) == want
    for seq in (1, 8, 40, 1000):
        assert decode_cache_len(cfg, seq) == jdecode_cache_len(jm.cfg, seq)


def _port_meta(cache):
    """(shape, dtype name) per leaf, the per-layer lists stacked as the
    reference stacks them."""
    def stack(dicts):
        return {k: ((len(dicts),) + tuple(dicts[0][k].shape),
                    str(dicts[0][k].dtype).replace("torch.", "")) for k in dicts[0]}

    if isinstance(cache, dict):
        return {k: stack(v) for k, v in cache.items()}
    return stack(cache)


def test_cache_converters_round_trip():
    """A reference cache mid-sequence crosses to the port and back
    unchanged; bf16 leaves keep their dtype on the port and widen exactly."""
    for over in (dict(num_layers=4), dict(num_layers=4, dtype="bfloat16")):
        cfg, jm, tree = reference("zamba2-7b", over)
        jcache = jm.init_cache(2, 8)
        jcache = jm.decode_step(tree, jcache, jnp.ones((2, 1), jnp.int32), jnp.int32(0))[1]
        jcache = jax.tree.map(np.asarray, jcache)
        cache = lm_cache_from_jax(jcache, cfg, "cpu")
        assert len(cache["mamba"]) == 4 and len(cache["attn"]) == 2
        assert cache["mamba"][0]["ssm"].dtype == torch.float32
        assert cache["attn"][1]["k"].dtype == getattr(torch, cfg.dtype)
        back = lm_cache_to_numpy(cache)
        for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jcache)):
            np.testing.assert_array_equal(g, np.asarray(w, np.float32))
    with pytest.raises(ValueError, match="rows"):
        lm_cache_from_jax(jcache, dataclasses.replace(cfg, num_layers=6), "cpu")


# ---------------------------------------------------------------------------
# GQA and Mamba2 decode alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_len,window", [(20, 0), (20, 6), (8, 8)],
                         ids=["full", "window-in-full-cache", "ring"])
def test_gqa_decode_matches_reference_across_a_ring_wrap(cache_len, window):
    """Positions 0-19 from the same inputs and a cache carried on both
    sides; the 8-slot ring wraps at 8 and 16.  4 heads over 2 kv heads."""
    cfg = get_config("tinyllama-1.1b").reduced()
    jcfg = jget_config("tinyllama-1.1b").reduced()
    p = jattn.init_gqa(jax.random.PRNGKey(7), jcfg, jnp.float32)
    pt = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    jcache = jattn.init_kv_cache(jcfg, 2, cache_len, jnp.float32)
    cache = attention.init_kv_cache(cfg, 2, cache_len, torch.float32, "cpu")
    rng = np.random.default_rng(7)
    for pos in range(20):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jattn.gqa_decode(p, jcache, jnp.asarray(x), jnp.int32(pos), jcfg, window)
        got, out = attention.gqa_decode(pt, cache, torch.as_tensor(x), pos, cfg, window)
        assert out is cache
        _close(_np(got), want, 1e-5)
        _close(_np(cache["k"]), jcache["k"], 1e-5)
        _close(_np(cache["v"]), jcache["v"], 1e-5)


def test_mamba2_decode_matches_reference():
    """20 steps from the same inputs: outputs, conv history and fp32 state
    at every step."""
    cfg = get_config("zamba2-7b").reduced()
    jcfg = jget_config("zamba2-7b").reduced()
    p = jssm.init_mamba2(jax.random.PRNGKey(3), jcfg, jnp.float32)
    pt = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    jcache = jssm.init_mamba2_cache(jcfg, 2, jnp.float32)
    cache = ssm.init_mamba2_cache(cfg, 2, torch.float32, "cpu")
    assert cache["ssm"].dtype == torch.float32
    rng = np.random.default_rng(3)
    for _ in range(20):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jssm.mamba2_decode(p, jcache, jnp.asarray(x), jcfg)
        got, out = ssm.mamba2_decode(pt, cache, torch.as_tensor(x), cfg)
        assert out is cache and got.shape == (2, 1, cfg.d_model)
        _close(_np(got), want)
        _close(_np(cache["conv"]), jcache["conv"])
        _close(_np(cache["ssm"]), jcache["ssm"])


def test_mamba2_decode_state_equals_the_chunked_scan_state():
    """Stepping 32 positions (two chunks of 16) from an empty cache ends on
    ``ssd_chunked``'s final state of the prefill's scan inputs, and each
    step's output on ``mamba2_forward``'s."""
    cfg = get_config("zamba2-7b").reduced()
    model = Model(cfg, device="cpu")
    lp = model.init_params(torch.Generator().manual_seed(4))["layers"][0]["mamba"]
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator().manual_seed(4))
    cache = ssm.init_mamba2_cache(cfg, 2, torch.float32, "cpu")
    steps = torch.cat([ssm.mamba2_decode(lp, cache, x[:, t:t + 1], cfg)[0] for t in range(32)],
                      dim=1)
    _close(_np(steps), _np(ssm.mamba2_forward(lp, x, cfg)))
    _, _, xd, logdecay, Bc, Cc = ssm.scan_inputs(lp, x, cfg)
    _, state = ssm.ssd_chunked(xd, logdecay, Bc, Cc, cfg.ssm_chunk)
    _close(_np(cache["ssm"]), _np(state))
