"""The port's FedAR round as a whole against a live reference run.

The golden config of ``tests/test_golden_numerics.py`` (12 robots, Table II
with 60 samples each, ``small_model(32)``, 5 rounds of fedar +
``foolsgold_sketch``) runs through the reference engine in this process;
its init params cross over through ``convert.params_from_jax`` and its
threefry draws (``fold_in(PRNGKey(seed), round)``, then a 3-way split for
selection / latency) replay into the port through ``ReplayDraws``.  Trust
and the masks must match exactly; params and the defense history within
atol = rtol = 2e-4, the reference goldens' band for fp32 reduction order
over 5 rounds x 15 local steps.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_bookkeeping_equal, reference_draws, run_both

from repro.configs.fedar_mnist import fleet_fed as jfleet_fed
from repro.configs.fedar_mnist import small_model as jsmall_model
from repro.core.engine import FedAREngine as JEngine
from repro.core.resources import TaskRequirement as JReq
from repro.data.datasets import make_federated
from repro_torch.configs.fedar_mnist import fleet_fed, small_model
from repro_torch.convert import (
    GeneratorDraws,
    ReplayDraws,
    params_from_jax,
    params_to_numpy,
)
from repro_torch.core.engine import (
    FedAREngine,
    flatten,
    median_arrival_timeout,
    unflatten,
)
from repro_torch.core.fedar import FedARServer
from repro_torch.core.resources import TaskRequirement
from repro_torch.data.federated import table2_fleet

ROUNDS = 5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.parametrize("aggregation,defense", [
    ("fedar", "foolsgold_sketch"),  # the golden config
    ("fedavg", "none"),
])
def test_golden_config_matches_live_reference(aggregation, defense):
    jfed = jfleet_fed(12, defense=defense, aggregation=aggregation)
    jeng = JEngine(jsmall_model(32), jfed, JReq())
    ds = make_federated("table2", 12, samples_per_client=60)
    ev = (ds.x[0, :50], ds.y[0, :50])
    jstate, jouts = jeng.run(
        jeng.init_state(), {k: jnp.asarray(v) for k, v in ds.arrays().items()},
        rounds=ROUNDS, eval_set=(jnp.asarray(ev[0]), jnp.asarray(ev[1])),
    )

    data = table2_fleet(samples_per_client=60)
    for k, v in ds.arrays().items():
        np.testing.assert_array_equal(data[k], v)
    params, _ = params_from_jax(jeng.template)
    server = FedARServer(
        small_model(32), fleet_fed(12, defense=defense, aggregation=aggregation),
        TaskRequirement(), device="cpu",
        draws=ReplayDraws(**reference_draws(0, ROUNDS, 12)), init_params=params,
    )
    hist = server.run(data, rounds=ROUNDS, eval_set=ev)

    np.testing.assert_array_equal(np.stack(hist["trust"]), np.asarray(jouts.trust))
    np.testing.assert_array_equal(np.stack(hist["selected"]),
                                  np.asarray(jouts.selected))
    np.testing.assert_array_equal(np.stack(hist["on_time"]),
                                  np.asarray(jouts.on_time))
    np.testing.assert_array_equal(server.trust.participations.numpy(),
                                  np.asarray(jstate.trust.participations))
    np.testing.assert_array_equal(server.trust.failures.numpy(),
                                  np.asarray(jstate.trust.failures))
    np.testing.assert_allclose(server.state.params.numpy(),
                               np.asarray(jstate.params), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(server.fg_history.numpy(),
                               np.asarray(jstate.fg_history), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(hist["acc"], np.asarray(jouts.acc), atol=2e-4)
    np.testing.assert_allclose(hist["round_time"], np.asarray(jouts.round_time),
                               rtol=1e-6)
    np.testing.assert_array_equal(server.resources.battery.numpy(),
                                  np.asarray(jstate.resources.battery))
    assert server.round_idx == ROUNDS


@pytest.mark.parametrize("aggregation", ["fedar", "fedavg", "async"])
def test_dense_foolsgold_trajectory_matches_live_reference(aggregation):
    """Dense FoolsGold (the quickstart's 12-robot default, similarity over
    the full D-wide history) at the golden config: trust, the masks, the
    counters and the round times exactly; params and the defense history
    within atol = rtol = 2e-4."""
    jstate, jouts, server, hist = run_both(ROUNDS, aggregation=aggregation,
                                           defense="foolsgold")
    assert_bookkeeping_equal(jstate, jouts, server, hist)
    np.testing.assert_allclose(server.state.params.numpy(),
                               np.asarray(jstate.params), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(server.fg_history.numpy(),
                               np.asarray(jstate.fg_history), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(hist["acc"], np.asarray(jouts.acc), atol=2e-4)


def test_wide_hidden_round_matches_live_reference():
    """``small_model(320)``, a width past 256 (on the card the local-SGD
    kernel's wide instance, w1 streamed from L2), through both engines on
    the CPU: the 12-robot fleet with 60 samples, 2 rounds of fedar +
    foolsgold_sketch, replayed draws.  Trust, selection and masks exactly;
    params and the defense history within atol = rtol = 2e-4."""
    jstate, jouts, server, hist = run_both(2, hidden=320, defense="foolsgold_sketch")
    assert server.engine.model.cfg.hidden == 320
    assert_bookkeeping_equal(jstate, jouts, server, hist)
    np.testing.assert_allclose(server.state.params.numpy(),
                               np.asarray(jstate.params), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(server.fg_history.numpy(),
                               np.asarray(jstate.fg_history), rtol=2e-4, atol=2e-4)


def test_imports_leave_out_jax_and_reference():
    """Importing every module of the port, the LM trunk's and its two
    kernels', the fault schedule's, the cohort engine's, the checkpoints',
    the optimizers' and the launchers' included, pulls in neither JAX nor
    the reference package (nor ``msgpack``)."""
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'msgpack')]\n"
        "assert not bad, bad\n"
        "lm = {'repro_torch.models.' + m for m in ('model', 'attention', 'ssm', 'blocks',\n"
        "      'ffn', 'layers')} | {'repro_torch.kernels.flash_attention',\n"
        "      'repro_torch.kernels.ssm_scan', 'repro_torch.configs.zamba2_7b',\n"
        "      'repro_torch.configs.tinyllama_1_1b'}\n"
        "lm |= {'repro_torch.core.faults', 'repro_torch.core.client_store',\n"
        "       'repro_torch.checkpoint.ckpt'}\n"
        "lm |= {'repro_torch.optim.' + m for m in ('optimizers', 'schedule')}\n"
        "lm |= {'repro_torch.launch.' + m for m in ('train', 'mesh', 'sharding',\n"
        "       'input_specs', 'dryrun')}\n"
        "assert lm <= set(sys.modules), lm - set(sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_the_card():
    """No ``device`` means ``cuda``; without a CUDA device that raises
    instead of falling back to the CPU."""
    fed = fleet_fed(12, defense="none")
    if torch.cuda.is_available():
        assert FedAREngine(small_model(8), fed, TaskRequirement()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        FedAREngine(small_model(8), fed, TaskRequirement())
    with pytest.raises(RuntimeError, match="CUDA"):
        FedARServer(small_model(8), fed, TaskRequirement())


@pytest.mark.parametrize("knob", ["sgd_impl", "agg_impl", "defense_impl"])
def test_kernel_route_on_cpu_raises(knob):
    fed = fleet_fed(12, defense="foolsgold_sketch", **{knob: "kernel"})
    with pytest.raises(RuntimeError, match="CUDA"):
        FedAREngine(small_model(8), fed, TaskRequirement(), device="cpu")


@pytest.mark.parametrize("override", [
    dict(mesh_shape=4), dict(mesh_shape=2, faults="chaos"),
    dict(mesh_shape=4, cohort_size=4),
])
def test_later_slice_features_raise(override):
    """A mesh without a process group of its size is refused, alone and
    beside the faults and the cohort size (the client mesh runs in the
    ranks ``core.distributed.spawn`` starts; tests/test_torch_mesh.py)."""
    fed = fleet_fed(12, defense="none", **override)
    with pytest.raises(RuntimeError, match="process group"):
        FedAREngine(small_model(8), fed, TaskRequirement(), device="cpu")


def test_server_strips_whole_fleet_cohort():
    """cohort_size >= N is the resident engine, as in the reference."""
    server = FedARServer(small_model(8), fleet_fed(12, defense="none",
                                                   cohort_size=12),
                         TaskRequirement(), device="cpu")
    assert server.fed.cohort_size is None


def test_weight_converter_round_trip():
    jeng = JEngine(jsmall_model(16), jfleet_fed(12, defense="none"), JReq())
    params, flat = params_from_jax(jeng.template)
    assert list(params) == ["b1", "b2", "w1", "w2"]
    back = params_to_numpy(params)
    for k, v in jeng.template.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    from repro.core.engine import flatten as jflatten
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflatten(jeng.template)))
    assert torch.equal(flatten(unflatten(flat, params)), flat)


def test_masked_round_and_standalone_draws():
    """A ragged fleet (mask) runs through the engine, the all-False client
    keeps an exactly-zero delta (never contributes), and the default
    generator draws depend only on (seed, round)."""
    draws = GeneratorDraws(3)
    assert torch.equal(draws.gumbel(2, 12), GeneratorDraws(3).gumbel(2, 12))
    assert not torch.equal(draws.gumbel(2, 12), draws.gumbel(3, 12))
    data = table2_fleet(samples_per_client=40)
    mask = np.ones((12, 40), bool)
    mask[0, 30:] = False
    mask[4, :] = False
    data["mask"] = mask
    fed = fleet_fed(12, defense="foolsgold_sketch")
    eng = FedAREngine(small_model(8), fed, TaskRequirement(), device="cpu")
    state, outs = eng.run(eng.init_state(), data, rounds=2)
    assert torch.isfinite(state.params).all()
    assert outs.trust.shape == (2, 12)
    assert eng.defense.history_dim(eng.dim) == 256
    g = flatten(eng.template)
    fields = eng.device_data(data)
    rows = eng._block_sgd(g, {k: fields[k] for k in eng.model.data_keys},
                          fields["mask"])
    assert torch.equal(rows[4], g)


def test_median_arrival_timeout_lets_half_the_honest_robots_arrive():
    """The timeout worked out from the fleet's latencies (the LM example's
    at full width): run through the engine, every round at least half of
    the honest robots arrive in time, and the worst round's median one
    only just; some robot straggles."""
    import dataclasses

    fed = fleet_fed(8, defense="none")
    data = table2_fleet(samples_per_client=40)
    data = {k: v[:8] for k, v in data.items()}
    eng = FedAREngine(small_model(8), fed, TaskRequirement(), device="cpu")
    flops = eng._train_flops(eng.device_data(data))
    rounds = 4
    timeout = median_arrival_timeout(fed, train_flops=flops, model_bytes=4.0 * eng.dim,
                                     rounds=rounds)
    eng = FedAREngine(small_model(8), dataclasses.replace(fed, timeout=timeout),
                      TaskRequirement(), device="cpu")
    _, outs = eng.run(eng.init_state(), data, rounds=rounds)
    honest = torch.as_tensor(~eng.poison_mask)
    on_time = outs.on_time[:, honest]
    assert (on_time.sum(dim=1) >= -(-int(honest.sum()) // 2)).all()
    assert not outs.on_time.all()


def test_dense_foolsgold_round_on_cpu():
    """The dense strategy (the quickstart's 12-robot default) runs the
    similarity block with K = D."""
    fed = fleet_fed(12, defense="foolsgold")
    eng = FedAREngine(small_model(8), fed, TaskRequirement(), device="cpu")
    state, _ = eng.run(eng.init_state(), table2_fleet(samples_per_client=20),
                       rounds=2)
    assert state.fg_history.shape == (12, eng.dim)
    assert torch.isfinite(state.params).all()


def test_flatten_rows_matches_rowwise():
    p = {"w": torch.randn(3, 2, 2), "b": torch.randn(3, 2)}
    rows = flatten(p, rows=True)
    for r in range(3):
        assert torch.equal(rows[r], flatten({k: v[r] for k, v in p.items()}))

