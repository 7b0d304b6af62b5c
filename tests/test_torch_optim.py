"""The port's trainer pieces against the reference, on the CPU: the configs
(``TrainConfig``, ``InputShape``, ``INPUT_SHAPES``, ``MeshConfig``,
``cfg_for_shape``), the LR schedules, the three optimizers on the same
numpy trees, and ``launch/train.py``'s ``build_train_step`` against the
reference's jitted step from converted params.

Tolerances: schedules within one fp32 rounding (rtol 1e-6); the
optimizers in fp32 within atol = rtol = 1e-5 after 5 steps (sums in
another order: the global norm, XLA's fused update); the trainer's losses,
AdamW ``m`` and ``v`` within 2e-4 (the LM band of
``tests/test_torch_lm_train.py``), params within the AdamW bound below.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import config as jconfig
from repro.configs import cfg_for_shape as jcfg_for_shape
from repro.configs import get_config as jget_config
from repro.core.engine import flatten as jflatten
from repro.launch.train import TrainState as JTrainState
from repro.launch.train import build_train_step as jbuild_train_step
from repro.models.model import Model as JModel
from repro.optim.optimizers import apply_updates as japply_updates
from repro.optim.optimizers import make_optimizer as jmake_optimizer
from repro.optim.schedule import make_schedule as jmake_schedule
from repro_torch.common import config as tconfig
from repro_torch.configs import ARCH_IDS, LONG_WINDOW, cfg_for_shape, get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.core.engine import flatten
from repro_torch.data.pipeline import lm_batches
from repro_torch.launch.train import TrainState, build_train_step
from repro_torch.models.model import Model
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.optim.optimizers import apply_updates, tree_map

OPT_TOL = 1e-5
TRAIN_TOL = 2e-4



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are small; when parallel test workers share
    the cores, PyTorch's intra-op thread pool makes each of them wait on the
    others (the 25-step driver took ~120 s beside other workers, ~8 s
    alone), so this module runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", ["TrainConfig", "InputShape", "MeshConfig"])
def test_config_fields_and_defaults_equal_the_reference(name):
    got, want = getattr(tconfig, name), getattr(jconfig, name)
    fields = [(f.name, f.default) for f in dataclasses.fields(got)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(want)]
    if name == "MeshConfig":
        assert got(2, 4, 3).num_devices == want(2, 4, 3).num_devices == 24


def test_input_shapes_equal_the_reference():
    assert tconfig.INPUT_SHAPES.keys() == jconfig.INPUT_SHAPES.keys()
    for k, want in jconfig.INPUT_SHAPES.items():
        got = tconfig.INPUT_SHAPES[k]
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.is_decode == want.is_decode


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cfg_for_shape_equals_the_reference(arch):
    """All four shapes: only long_500k caps the attention windows at
    LONG_WINDOW, and only for archs with attention."""
    for name in tconfig.INPUT_SHAPES:
        got = cfg_for_shape(get_config(arch), tconfig.INPUT_SHAPES[name])
        want = jcfg_for_shape(jget_config(arch), jconfig.INPUT_SHAPES[name])
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, name)
        if name == "long_500k" and got.attention != "none":
            assert 0 < got.sliding_window <= LONG_WINDOW


# ---------------------------------------------------------------- schedules
SCHEDULES = [
    dict(),
    dict(warmup_steps=10),
    dict(schedule="cosine", warmup_steps=10, total_steps=100, lr=3e-3),
    dict(schedule="cosine", total_steps=50),
]


@pytest.mark.parametrize("over", SCHEDULES)
def test_schedule_equals_the_reference(over):
    tc = tconfig.TrainConfig(**over)
    got, want = make_schedule(tc), jmake_schedule(jconfig.TrainConfig(**over))
    for step in (0, 1, tc.warmup_steps, (tc.warmup_steps + tc.total_steps) // 2,
                 tc.total_steps):
        np.testing.assert_allclose(float(got(step)), float(want(jnp.int32(step))),
                                   rtol=1e-6, err_msg=f"step {step}")


# --------------------------------------------------------------- optimizers
def _tree(rng, dtype=np.float32):
    """A tree of the port's shape: nested dicts and a list of per-layer
    dicts (the reference takes the same nesting as a pytree)."""
    layer = lambda: {"w": rng.standard_normal((4, 5)), "b": rng.standard_normal(5)}
    t = {"embed": rng.standard_normal((6, 4)), "layers": [layer(), layer()],
         "norm": {"scale": rng.standard_normal(4)}}
    return jax.tree.map(lambda a: np.asarray(a, dtype), t)


def _torch_tree(t):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), t)


def _flat(t):
    """A tree's leaves in ``jax.tree.leaves`` order (its list entries in
    turn), as one fp32 vector: port trees of tensors and reference trees
    alike."""
    leaves = jax.tree.leaves(jax.tree.map(
        lambda a: a.to(torch.float32).numpy() if isinstance(a, torch.Tensor)
        else np.asarray(a, np.float32), t))
    return np.concatenate([np.ravel(a) for a in leaves]) if leaves else np.zeros(0)


OPT_CASES = [(opt, clip, sched) for opt in ("sgd", "momentum", "adamw")
             for clip in (0.0, 1.0) for sched in (False, True)]


@pytest.mark.parametrize("opt,clip,sched", OPT_CASES)
def test_optimizer_equals_the_reference(opt, clip, sched):
    """5 steps of each optimizer on the same params and gradients (scaled
    so that a clip of 1.0 bites), with and without the clip, with a
    constant lr or a warmup-cosine schedule: params and state in fp32."""
    kw = dict(optimizer=opt, lr=0.05, weight_decay=0.01, grad_clip=clip,
              schedule="cosine" if sched else "const", warmup_steps=2 if sched else 0,
              total_steps=5)
    tc, jtc = tconfig.TrainConfig(**kw), jconfig.TrainConfig(**kw)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    o = make_optimizer(tc, make_schedule(tc) if sched else None)
    jo = jmake_optimizer(jtc, jmake_schedule(jtc) if sched else None)
    params, jparams = _torch_tree(p0), jax.tree.map(jnp.asarray, p0)
    state, jstate = o.init(params), jo.init(jparams)
    for step in range(5):
        g = jax.tree.map(lambda a: a * 3.0, _tree(rng))
        upd, state = o.update(_torch_tree(g), state, params, step)
        params = apply_updates(params, upd)
        jupd, jstate = jo.update(jax.tree.map(jnp.asarray, g), jstate, jparams,
                                 jnp.int32(step))
        jparams = japply_updates(jparams, jupd)
    np.testing.assert_allclose(_flat(params), _flat(jparams),
                               rtol=OPT_TOL, atol=OPT_TOL)
    for k in (jstate or {}):
        np.testing.assert_allclose(_flat(state[k]), _flat(jstate[k]),
                                   rtol=OPT_TOL, atol=OPT_TOL, err_msg=k)


def test_adamw_keeps_bf16_params_bf16_and_its_state_fp32():
    """bf16 params: fp32 m and v equal to the reference's, the update cast
    to bf16 and added in bf16 (no master copy), within one bf16 ulp of
    the reference's params."""
    tc = tconfig.TrainConfig(optimizer="adamw", lr=0.05)
    rng = np.random.default_rng(1)
    p0 = _tree(rng)
    params = tree_map(lambda t: t.to(torch.bfloat16), _torch_tree(p0))
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p0)
    o, jo = make_optimizer(tc), jmake_optimizer(jconfig.TrainConfig(optimizer="adamw",
                                                                    lr=0.05))
    state, jstate = o.init(params), jo.init(jparams)
    for step in range(3):
        g = _tree(rng)
        upd, state = o.update(tree_map(lambda t: t.to(torch.bfloat16), _torch_tree(g)),
                              state, params, step)
        params = apply_updates(params, upd)
        jupd, jstate = jo.update(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g),
                                 jstate, jparams, jnp.int32(step))
        jparams = japply_updates(jparams, jupd)
    tree_map(lambda t: None if t.dtype == torch.bfloat16 else pytest.fail(t.dtype), params)
    for k in ("m", "v"):
        tree_map(lambda t: None if t.dtype == torch.float32 else pytest.fail(t.dtype),
                 state[k])
        np.testing.assert_allclose(_flat(state[k]), _flat(jstate[k]),
                                   rtol=OPT_TOL, atol=OPT_TOL)
    np.testing.assert_allclose(_flat(params), _flat(jparams),
                               rtol=2 ** -7, atol=2 ** -7)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(tconfig.TrainConfig(optimizer="lion"))


# ------------------------------------------------------------------ trainer
TRAIN_CASES = {
    "tinyllama-1.1b": {},
    # dropless, so that no routing decision hangs on a capacity cut
    "qwen2-moe-a2.7b": dict(moe_capacity_factor=16.0),
}


@pytest.mark.parametrize("arch", list(TRAIN_CASES))
def test_train_step_equals_the_reference_jitted_step(arch):
    """3 AdamW steps (lr 3e-3, remat) of reduced fp32 configs from the
    reference's params: the losses (with qwen2's aux loss), ``m`` and ``v``
    within 2e-4.  Params: AdamW's update m / (sqrt(v) + eps) amplifies a
    gradient ulp where |g| ~ eps into up to ~lr of step, so each param is
    held within 2e-4 + lr x (its steps' count of such amplified updates),
    bounded here by 2e-4 + 3 lr, and all but 0.1% of them within 2e-4."""
    over = TRAIN_CASES[arch]
    jcfg = jget_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    jm, m = JModel(jcfg), Model(cfg, "cpu")
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    kw = dict(optimizer="adamw", lr=3e-3, remat=True)
    tc, jtc = tconfig.TrainConfig(**kw), jconfig.TrainConfig(**kw)
    params = lm_params_from_jax(tree, cfg, "cpu")
    state = TrainState(params, make_optimizer(tc).init(params), 0)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = JTrainState(jparams, jmake_optimizer(jtc).init(jparams), jnp.int32(0))
    step, jstep = build_train_step(m, tc), jax.jit(jbuild_train_step(jm, jtc))
    losses, jlosses = [], []
    for batch in lm_batches(cfg, batch=4, seq=32, steps=3, seed=1):
        state, mets = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
        jstate, jmets = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append([float(mets[k]) for k in ("loss", "nll", "aux")])
        jlosses.append([float(jmets[k]) for k in ("loss", "nll", "aux")])
    assert state.step == int(jstate.step) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=TRAIN_TOL, atol=TRAIN_TOL)
    if arch.startswith("qwen2"):
        assert min(l[2] for l in losses) > 0  # the aux loss is in the step
    for k in ("m", "v"):
        np.testing.assert_allclose(flatten(state.opt_state[k]).numpy(),
                                   np.asarray(jflatten(jstate.opt_state[k])),
                                   rtol=TRAIN_TOL, atol=TRAIN_TOL, err_msg=k)
    err = np.abs(flatten(state.params).numpy() - np.asarray(jflatten(jstate.params)))
    assert err.max() <= TRAIN_TOL + 3 * tc.lr, err.max()
    assert (err > TRAIN_TOL).mean() <= 1e-3, (err > TRAIN_TOL).mean()
    moved = np.abs(flatten(state.params).numpy() - flatten(params).numpy()).max()
    assert moved > 0
