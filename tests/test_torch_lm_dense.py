"""The dense GQA configs ``gemma3-1b`` and ``yi-9b`` in the port against the
reference, on the CPU: the configs field by field, ``Model.prefill`` /
``forward`` and 40 decode steps from the reference's params
(``convert.lm_params_from_jax``), kernel 8's plain version at head_dim 256,
and the port's serving example.

Beyond ``reduced()`` (2 layers, both local-window layers in gemma3, head_dim
64) two gemma3 reductions reach what the full model runs: 7 layers, so that
layer 5 is global (full causal) between local ones, and head_dim 256, the
full model's.  Inputs are numpy arrays made from a seed; everything runs in
fp32 on the plain route (the CPU's ``auto``).  The CUDA kernel at head_dim
256 is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash_kernel
from repro.models.model import Model as JModel
from repro.models.model import layer_windows as jlayer_windows
from repro_torch.configs import PORTED, get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM
from repro_torch.models.model import Model, decode_cache_len, layer_windows

# fp32, the same function with sums in another order (the probe of these
# reductions measured 1.6e-6 to 5.1e-6)
TOL = 1e-5
DENSE = ("gemma3-1b", "yi-9b")
# (arch, overrides of reduced()): the two reductions, gemma3 with a global
# layer (layer 5 of 7) and gemma3 at its full head_dim
CASES = [
    ("gemma3-1b", {}),
    ("yi-9b", {}),
    ("gemma3-1b", dict(num_layers=7)),
    ("gemma3-1b", dict(head_dim=256)),
]
IDS = ["gemma3-1b", "yi-9b", "gemma3-7layers", "gemma3-hd256"]
# decode reaches no attention kernel, so head_dim 256 adds nothing there
DECODE_CASES, DECODE_IDS = CASES[:3], IDS[:3]
PROMPT, STEPS = 16, 40  # 40 decode steps: past the reduced local window of 32
S = 48                  # prefill length, past the window too
# kernel 8's plain version: tolerances of tests/test_torch_lm_kernels.py
FP32_TOL, BF16_TOL = 1e-5, 1.6e-2
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np(t):
    return t.detach().to(torch.float32).numpy()


@functools.lru_cache(maxsize=None)
def reference(arch, over_items=()):
    """(port config, reference model, its params as numpy leaves, the port's
    params converted from them, the port's CPU model)."""
    over = dict(over_items)
    jcfg = jget_config(arch).reduced(**over)
    jm = JModel(jcfg)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    cfg = get_config(arch).reduced(**over)
    return cfg, jm, tree, lm_params_from_jax(tree, cfg, "cpu"), Model(cfg, device="cpu",
                                                                      attn_impl="einsum")


def tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_equal_the_reference_field_by_field(arch):
    """The full configs, the reductions this file runs, their head dims and
    per-layer windows (gemma3-1b: 22 local layers of 512, 4 global)."""
    assert arch in PORTED
    cfg, jcfg = get_config(arch), jget_config(arch)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    for _, over in [c for c in CASES if c[0] == arch]:
        assert (dataclasses.asdict(cfg.reduced(**over))
                == dataclasses.asdict(jcfg.reduced(**over)))
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim <= MAX_HEAD_DIM
    np.testing.assert_array_equal(layer_windows(cfg), jlayer_windows(jcfg))
    if arch == "gemma3-1b":
        w = layer_windows(cfg)
        assert (w == 512).sum() == 22 and (w == 0).sum() == 4 and cfg.resolved_head_dim == 256
        assert cfg.tie_embeddings and cfg.act == "gelu"
    else:
        assert (layer_windows(cfg) == 0).all() and cfg.num_heads // cfg.num_kv_heads == 8


# ---------------------------------------------------------------------------
# the slice: prefill, forward and decode from the reference's params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_prefill_and_forward_match_reference(arch, over):
    """B = 2, S = 48 (past the reduced local window of 32), fp32, on the
    plain attention route; logits at every position and at the last."""
    cfg, jm, tree, params, model = reference(arch, tuple(over.items()))
    toks = tokens(cfg, 2, S)
    batch, jbatch = {"tokens": torch.as_tensor(toks)}, {"tokens": jnp.asarray(toks)}
    _close(_np(model.prefill(params, batch)), jm.prefill(tree, jbatch))
    logits, aux = model.forward(params, batch)
    jlogits, _ = jm.forward(tree, jbatch)
    assert logits.shape == (2, S, cfg.vocab_size) and float(aux) == 0.0
    _close(_np(logits), jlogits)


@pytest.mark.parametrize("arch,over", DECODE_CASES, ids=DECODE_IDS)
def test_decode_steps_match_reference(arch, over):
    """B = 2: a 16-token prompt then 24 of the reference's greedy tokens, 40
    steps, both models fed the same token at every step; logits at every
    step.  The reduced gemma3's ring of 32 slots wraps, and the 7-layer one
    keeps full-length caches for its global layer while its local layers
    mask to the window."""
    cfg, jm, tree, params, model = reference(arch, tuple(over.items()))
    toks = tokens(cfg, 2, PROMPT, seed=1)
    cache, jcache = model.init_cache(2, STEPS), jm.init_cache(2, STEPS)
    expect_len = 32 if arch == "gemma3-1b" and cfg.num_layers < 6 else STEPS
    assert decode_cache_len(cfg, STEPS) == expect_len == cache[0]["k"].shape[1]
    step = jax.jit(jm.decode_step)
    tok = toks[:, :1]
    for t in range(STEPS):
        jlogits, jcache = step(tree, jcache, jnp.asarray(tok), jnp.int32(t))
        logits, cache = model.decode_step(params, cache, torch.as_tensor(tok), t)
        _close(_np(logits), jlogits)
        tok = (toks[:, t + 1:t + 2] if t + 1 < PROMPT
               else np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32))


# ---------------------------------------------------------------------------
# kernel 8's plain version at head_dim 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("window", [0, 40])
def test_flash_attention_plain_at_head_dim_256_matches_reference(dtype, window):
    """(B, S, H, hd) = (1, 96, 2, 256) against the jnp oracle and the Pallas
    kernel in interpret mode (32 x 32 blocks)."""
    tol = FP32_TOL if dtype == "fp32" else BF16_TOL
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal((1, 96, 2, 256)).astype(np.float32) for _ in range(3)]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in arrays)
    got = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    assert got.dtype == tdt and got.shape == tq.shape
    _close(_np(got), jref.flash_attention_ref(jq, jk, jv, causal=True, window=window), tol)
    kern = jax_flash_kernel(jq, jk, jv, causal=True, window=window, interpret=True,
                            block_q=32, block_k=32)
    _close(_np(got), kern, tol)


# ---------------------------------------------------------------------------
# the port's serving example
# ---------------------------------------------------------------------------

def test_serve_decode_example_runs_on_the_cpu(capsys):
    path = Path(__file__).resolve().parents[1] / "examples" / "serve_decode_torch.py"
    spec = importlib.util.spec_from_file_location("serve_decode_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("sample token ids:"))
    ids = [int(x) for x in line.split(":", 1)[1].strip(" []").split(",")]
    assert len(ids) == 12
    assert all(0 <= i < get_config("gemma3-1b").reduced().vocab_size for i in ids)
