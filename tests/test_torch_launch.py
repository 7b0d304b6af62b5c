"""The port's launchers against the reference, on the CPU: the sharding
policy on all ten architectures' full-width param and decode-cache trees
(on ``meta``) over the (16, 16) and (2, 16, 16) production meshes, the
dry run's param counts and records, the meshes, and the training driver.

The reference stacks its layers (and caches) on a leading L axis; the port
keeps per-layer lists, so the port's spec trees are stacked here (each
layer's spec checked equal, an L entry of None put in front) before they
are held against the reference's ``PartitionSpec`` trees, entry for entry.
"""
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.common.config import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import sharding as jsharding
from repro.launch.input_specs import abstract_params as jabstract_params
from repro.launch.input_specs import input_specs as jinput_specs
from repro.models.model import Model as JModel
from repro.models.model import param_count as jparam_count
from repro_torch.checkpoint.ckpt import restore
from repro_torch.common.config import INPUT_SHAPES
from repro_torch.configs import ARCH_IDS, cfg_for_shape, get_config
from repro_torch.launch import dryrun, sharding
from repro_torch.launch.input_specs import abstract_params, input_specs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.train import main
from repro_torch.models.model import Model, param_count

ROOT = Path(__file__).resolve().parents[1]



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

def _stand_in(mesh):
    """The reference's side of a mesh: axis names and a devices array."""
    return SimpleNamespace(axis_names=mesh.axis_names, devices=np.empty(mesh.shape))


def _as_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _stacked(specs):
    """The port's spec tree in the reference's layout: a list of per-layer
    trees becomes one tree of (None, *spec) entries."""
    if isinstance(specs, dict):
        return {k: _stacked(v) for k, v in specs.items()}
    if isinstance(specs, list):
        if isinstance(specs[0], dict):
            return {k: _stacked([d[k] for d in specs]) for k in specs[0]}
        assert all(s == specs[0] for s in specs), specs
        return (None, *specs[0])
    return specs


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference_at_full_width(arch, multi_pod):
    """param_specs under both policies, batch_specs of the train and
    prefill batches, cache_specs of the decode_32k cache; and the port's
    meta params count what the reference's abstract params count."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    jmesh = _stand_in(mesh)
    cfg, jcfg = get_config(arch), jget_config(arch)
    params, jparams = abstract_params(cfg), jabstract_params(jcfg)
    assert param_count(params) == jparam_count(jparams)
    for policy in ("fsdp_tp", "tp_only"):
        got = _stacked(sharding.param_specs(params, mesh, policy=policy))
        assert got == _as_tuples(jsharding.param_specs(jparams, jmesh, policy=policy)), policy
    for name in ("train_4k", "prefill_32k"):
        got = sharding.batch_specs(input_specs(cfg, INPUT_SHAPES[name]), mesh)
        want = jsharding.batch_specs(jinput_specs(jcfg, JSHAPES[name]), jmesh)
        assert got == _as_tuples(want), name
    B, S = 128, 32768
    cache = Model(cfg, "meta").init_cache(B, S)
    jcache = jax.eval_shape(lambda: JModel(jcfg).init_cache(B, S))
    got = _stacked(sharding.cache_specs(cache, mesh))
    assert got == _as_tuples(jsharding.cache_specs(jcache, jmesh))


@pytest.mark.parametrize("shape", [(1, 64), (256, 4096), (4, 6, 8), (16, 12, 128, 32)])
@pytest.mark.parametrize("model,data", [(16, 16), (4, 2), (1, 16)])
def test_leaf_spec_equals_the_reference(shape, model, data):
    assert sharding.leaf_spec(shape, model, data) == tuple(
        jsharding.leaf_spec(shape, model, data, skip_leading=False))


def test_meshes():
    """The production layouts; a host mesh on the CPU when asked for,
    and without a card the default raises."""
    m = make_production_mesh()
    assert (m.shape, m.axis_names, m.size) == ((16, 16), ("data", "model"), 256)
    m = make_production_mesh(multi_pod=True)
    assert (m.shape, m.axis_names, m.size) == ((2, 16, 16), ("pod", "data", "model"), 512)
    assert m.axis_size("pod") == 2 and make_host_mesh(4, 2, device="cpu").shape == (1, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_lower_one_on_tinyllama(shape):
    """One dry-run record a shape: the reference's param count, FLOPs
    within the step's matmul count, per-device bytes split over the mesh,
    no collective bytes."""
    rec = dryrun.lower_one("tinyllama-1.1b", shape)
    cfg, s = get_config("tinyllama-1.1b"), INPUT_SHAPES[shape]
    n = jparam_count(jabstract_params(jget_config("tinyllama-1.1b")))
    assert rec["params"] == n and rec["chips"] == 256 and rec["kind"] == s.kind
    assert rec["collective_bytes"] is None
    B, S = s.global_batch, s.seq_len
    window = cfg_for_shape(cfg, s).sliding_window or S
    q = 1 if s.kind == "decode" else S
    dense = 2 * (n - cfg.vocab_size * cfg.d_model) * B * q  # the non-embedding GEMMs
    # the plain route's scores and values over every key a query may see
    attn = 4 * B * q * min(S, window) * cfg.num_heads * cfg.resolved_head_dim * cfg.num_layers
    factor = {"train": 4, "prefill": 1, "decode": 1}[s.kind]  # remat: 2 forwards, 1 backward
    assert factor * dense <= rec["flops"] <= factor * (dense + attn) * 1.2, rec["flops"] / dense
    assert rec["flops_per_device"] == rec["flops"] / 256
    assert rec["t_compute"] > 0 and rec["t_memory"] > 0
    assert rec["param_bytes"] * 256 >= 2 * n  # bf16, sharded at most 256 ways
    assert (rec["opt_state_bytes"] == 0) and (rec["cache_bytes"] is None) == (s.kind != "decode")


def test_dryrun_main_prints_ok(capsys):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "long_500k", "--multi-pod"])
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert re.search(r"\[OK\] tinyllama-1.1b x long_500k multi_pod=True params=1,100,048,384",
                     out), out


def test_launch_imports_have_no_side_effect():
    """Importing the launchers and optimizers leaves the environment alone
    (the reference's dry run sets XLA_FLAGS at import) and pulls in
    neither JAX nor the reference."""
    code = (
        "import os, sys\n"
        "env = dict(os.environ)\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.train, repro_torch.optim\n"
        "assert dict(os.environ) == env\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr


def test_train_driver_runs_and_learns(capsys, tmp_path):
    """The counterpart of tests/test_system.py's driver test, on the CPU:
    25 steps with the loss falling, and the checkpoint restored bit-equal."""
    ckpt = str(tmp_path / "params.pt")
    state = main(["--arch", "tinyllama-1.1b", "--steps", "25", "--batch", "8",
                  "--seq", "64", "--lr", "3e-3", "--device", "cpu", "--ckpt", ckpt])
    assert state.step == 25
    losses = [float(v) for v in re.findall(r"step +\d+ loss ([\d.]+)", capsys.readouterr().out)]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 1.0, losses
    back, step = restore(ckpt, state.params)
    assert step == 25
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_driver_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--steps", "1"])
