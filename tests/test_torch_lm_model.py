"""The port's LM trunk (``repro_torch.models``) against the reference's, on
the CPU: configs, layers, GQA, Mamba2, the blocks and ``Model.prefill`` /
``Model.forward`` from the same parameters (``convert.lm_params_from_jax``).

Inputs and tokens are numpy arrays made from a seed; the reference's params
come from its own ``init_params`` and cross as numpy arrays.  Everything
runs in fp32 on the plain route (``attn_impl = ssm_impl = "auto"`` on the
CPU); the kernel route is held against it on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ModelConfig as JModelConfig
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import ffn as jffn
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models.model import Model as JModel
from repro.models.model import layer_windows as jlayer_windows
from repro.models.model import param_count as jparam_count
from repro_torch.common.config import ModelConfig
from repro_torch.configs import ARCH_IDS, PORTED, get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import attention, blocks, ffn, layers, ssm
from repro_torch.models.model import Model, layer_windows, param_count

TOL = 1e-4  # fp32, the same function with sums in another order
SLICE = [("zamba2-7b", dict(num_layers=4)), ("tinyllama-1.1b", {})]
# the reference's per-leaf rule: these stay fp32 in a bf16 model
FP32_LEAVES = {"final_norm", "ln", "ln1", "ln2", "norm", "A_log", "D", "dt_bias"}


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def reference(arch, seed=0, **over):
    """(port config, reference model, reference params as numpy leaves)."""
    jcfg = jget_config(arch).reduced(**over)
    jm = JModel(jcfg)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    return get_config(arch).reduced(**over), jm, tree


def tokens(cfg, B=2, S=64, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_model_config_fields_and_defaults_pin_the_reference():
    ours = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JModelConfig)}
    assert ours == theirs


@pytest.mark.parametrize("arch", PORTED)
def test_ported_configs_and_their_reductions_equal_the_reference(arch):
    assert set(PORTED) == set(ARCH_IDS)
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget_config(arch))
    for over in ({}, dict(num_layers=4)):
        assert (dataclasses.asdict(get_config(arch).reduced(**over))
                == dataclasses.asdict(jget_config(arch).reduced(**over)))
    assert get_config(arch).resolved_head_dim == jget_config(arch).resolved_head_dim


def test_layer_windows_equal_the_reference():
    base = get_config("tinyllama-1.1b")
    for over in ({}, dict(sliding_window=64),
                 dict(global_every=3, local_window=32, sliding_window=0)):
        cfg = dataclasses.replace(base, **over)
        jcfg = dataclasses.replace(jget_config("tinyllama-1.1b"), **over)
        np.testing.assert_array_equal(layer_windows(cfg), jlayer_windows(jcfg))


# ---------------------------------------------------------------------------
# layers, FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    want = jlayers.rms_norm(jnp.asarray(x, dtype), jnp.asarray(scale), 1e-6)
    got = layers.rms_norm(_t(x).to(getattr(torch, dtype)), _t(scale), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    # bf16: both round the same fp32 result, up to an ulp of it
    _close(got, want, 1e-6 if dtype == "float32" else 1.6e-2)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope_matches_reference(theta):
    """Split-half rotation at positions 0..S-1, 3..S+2 per batch row."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 3, 32)).astype(np.float32)
    pos = np.stack([np.arange(16), np.arange(3, 19)]).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(layers.apply_rope(_t(x), _t(pos), theta), want, 1e-5)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activation_matches_reference(name):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    _close(layers.activation(name)(_t(x)), jlayers.activation(name)(jnp.asarray(x)), 1e-6)


def test_ffn_forward_matches_reference():
    p = jffn.init_ffn(jax.random.PRNGKey(0), 32, 64, jnp.float32)
    x = np.random.default_rng(2).standard_normal((2, 8, 32)).astype(np.float32)
    want = jffn.ffn_forward(p, jnp.asarray(x), "silu")
    _close(ffn.ffn_forward({k: _t(v) for k, v in p.items()}, _t(x), "silu"), want, 1e-5)


# ---------------------------------------------------------------------------
# GQA and Mamba2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,d_model,heads,kv,window", [
    (64, 256, 4, 2, 0),     # the reduced configs' width
    (64, 256, 4, 2, 16),    # sliding window
    (2048, 32, 2, 1, 0),    # two Q_CHUNK blocks of the triangular loop
    (2048, 32, 2, 1, 300),  # the loop with a window
])
def test_gqa_forward_matches_reference(S, d_model, heads, kv, window):
    cfg = get_config("tinyllama-1.1b").reduced(d_model=d_model, num_heads=heads,
                                                 num_kv_heads=kv, head_dim=16)
    jcfg = jget_config("tinyllama-1.1b").reduced(d_model=d_model, num_heads=heads,
                                                  num_kv_heads=kv, head_dim=16)
    p = jattn.init_gqa(jax.random.PRNGKey(S), jcfg, jnp.float32)
    x = np.random.default_rng(S).standard_normal((1, S, d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    want = jattn.gqa_forward(p, jnp.asarray(x), jnp.asarray(pos), jcfg, window)
    got = attention.gqa_forward({k: _t(v) for k, v in p.items()}, _t(x), _t(pos), cfg,
                                window)
    _close(got, want)


def test_plain_attention_route_rejects_a_ragged_chunk_count():
    q = torch.zeros(1, 1500, 1, 8)
    pos = torch.arange(1500)
    with pytest.raises(ValueError, match="multiple"):
        attention._attend_chunked(q, q, q, pos, pos, 0)


def test_mamba2_forward_matches_reference():
    cfg = get_config("zamba2-7b").reduced()
    jcfg = jget_config("zamba2-7b").reduced()
    p = jssm.init_mamba2(jax.random.PRNGKey(3), jcfg, jnp.float32)
    x = np.random.default_rng(3).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    want = jssm.mamba2_forward(p, jnp.asarray(x), jcfg)
    _close(ssm.mamba2_forward({k: _t(v) for k, v in p.items()}, _t(x), cfg), want)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 20, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    _close(ssm._causal_conv(_t(x), _t(w)), jssm._causal_conv(jnp.asarray(x), jnp.asarray(w)),
           1e-6)


# ---------------------------------------------------------------------------
# the slice: Model from the reference's params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,over", SLICE, ids=[a for a, _ in SLICE])
def test_prefill_and_forward_match_reference(arch, over):
    """B = 2, S = 64, fp32; zamba2's 4 layers apply the shared block twice.
    atol = rtol = 1e-4 (measured: 1.2e-5 prefill, 8.6e-5 forward at worst)."""
    cfg, jm, tree = reference(arch, **over)
    params = lm_params_from_jax(tree, cfg, "cpu")
    model = Model(cfg, device="cpu")
    toks = tokens(cfg)
    batch, jbatch = {"tokens": torch.as_tensor(toks)}, {"tokens": jnp.asarray(toks)}
    _close(model.prefill(params, batch), jm.prefill(tree, jbatch))
    logits, aux = model.forward(params, batch)
    jlogits, jaux = jm.forward(tree, jbatch)
    assert logits.shape == (2, 64, cfg.vocab_size)
    _close(logits, jlogits)
    assert float(aux) == float(jaux) == 0.0


def test_shared_block_applies_after_every_kth_layer():
    """Zeroing the shared block's output projections leaves the zamba
    trunk equal to the Mamba2 stack alone."""
    cfg, _, tree = reference("zamba2-7b", num_layers=4)
    params = lm_params_from_jax(tree, cfg, "cpu")
    model = Model(cfg, device="cpu")
    batch = {"tokens": torch.as_tensor(tokens(cfg, S=32))}
    base = model.prefill(params, batch)
    shared = params["shared_attn"]
    shared["attn"]["wo"] = torch.zeros_like(shared["attn"]["wo"])
    shared["ffn"]["w_down"] = torch.zeros_like(shared["ffn"]["w_down"])
    cut = model.prefill(params, batch)
    assert not torch.allclose(base, cut)
    x = torch.nn.functional.embedding(batch["tokens"].long(), params["embed"])
    for lp in params["layers"]:
        x = blocks.mamba_block_forward(lp, x, cfg)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    torch.testing.assert_close(cut, model.logits(params, x[:, -1]), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# weights and init
# ---------------------------------------------------------------------------

def _stacked(params):
    """The port's params back in the reference's tree: layers stacked."""
    def np_(t):
        return t.to(torch.float32).numpy()

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack([np_(n) for n in nodes])

    out = {k: (jax.tree.map(np_, v) if isinstance(v, dict) else np_(v))
           for k, v in params.items() if k != "layers"}
    out["layers"] = stack(params["layers"])
    return out


@pytest.mark.parametrize("arch,over", SLICE, ids=[a for a, _ in SLICE])
def test_lm_params_from_jax_round_trips(arch, over):
    cfg, _, tree = reference(arch, **over)
    params = lm_params_from_jax(tree, cfg, "cpu")
    assert len(params["layers"]) == cfg.num_layers
    assert param_count(params) == jparam_count(tree)
    back = _stacked(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, want)


def test_lm_params_keep_the_per_leaf_dtypes():
    """A bf16 reference tree crosses with its dtypes (fp32 norms, A_log, D,
    dt_bias; bf16 elsewhere), bit for bit; ``dtype`` recasts only the
    model-dtype leaves."""
    cfg, _, tree = reference("zamba2-7b", num_layers=2, dtype="bfloat16")
    params = lm_params_from_jax(tree, cfg, "cpu")
    for lp in params["layers"] + [params["shared_attn"], params]:
        for key, leaf in _named_leaves(lp):
            want = torch.float32 if key in FP32_LEAVES else torch.bfloat16
            assert leaf.dtype == want, key
    np.testing.assert_array_equal(
        params["layers"][1]["mamba"]["wz"].to(torch.float32).numpy(),
        np.asarray(tree["layers"]["mamba"]["wz"][1], np.float32))
    wide = lm_params_from_jax(tree, cfg, "cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32 for _, t in _named_leaves(wide))


def _named_leaves(tree, key=None):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k != "layers":
                yield from _named_leaves(v, k)
    else:
        yield key, tree


@pytest.mark.parametrize("arch,over", SLICE, ids=[a for a, _ in SLICE])
def test_init_params_shapes_and_dtypes_equal_the_reference(arch, over):
    """The port's own seeded init against ``jax.eval_shape`` of the
    reference's, in bf16 so the per-leaf dtype rule shows; the same seed
    gives the same params."""
    over = dict(over, dtype="bfloat16")
    cfg = get_config(arch).reduced(**over)
    jshapes = jax.eval_shape(JModel(jget_config(arch).reduced(**over)).init_params,
                             jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(5))
    assert _stacked_meta(params) == jax.tree.map(
        lambda s: (tuple(s.shape), str(s.dtype)), jshapes)
    again = model.init_params(torch.Generator().manual_seed(5))
    for a, b in zip(_named_leaves(params), _named_leaves(again)):
        assert torch.equal(a[1], b[1])
    assert param_count(params) == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jshapes))


def _stacked_meta(params):
    """(shape, dtype name) per leaf, layers stacked as the reference's."""
    def meta(t, lead=()):
        return (lead + tuple(t.shape), str(t.dtype).replace("torch.", ""))

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return meta(nodes[0], (len(nodes),))

    def walk(v):
        return {k: walk(x) for k, x in v.items()} if isinstance(v, dict) else meta(v)

    out = {k: walk(v) for k, v in params.items() if k != "layers"}
    out["layers"] = stack(params["layers"])
    return out


# ---------------------------------------------------------------------------
# device and kinds
# ---------------------------------------------------------------------------

def test_model_defaults_to_the_card():
    """No ``device`` means ``cuda``; without one that raises instead of
    falling back to the CPU."""
    cfg = get_config("zamba2-7b")
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    assert Model(cfg, device="cpu").device.type == "cpu"
