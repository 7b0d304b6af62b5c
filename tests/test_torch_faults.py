"""The port's fault injection against the live reference.

Each schedule (``crash``, ``corrupt``, ``battery``, ``flaky``, ``chaos``)
runs the golden-size config (12 robots, Table II with 60 samples each,
``small_model(32)``) through the reference engine and the port, on
``fedar`` and on ``async`` + 4-bit QSGD, from the reference's init params
with its threefry draws replayed (the fault coins included).  Trust, the
masks, the counters and the battery must match exactly; params and the
defense history within atol = rtol = 2e-4, the residual and the pending
buffer up to QSGD code flips (``assert_close_up_to_flips``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    assert_bookkeeping_equal,
    assert_close_up_to_flips,
    reference_draws,
    run_both,
)

from repro.common.config import FedConfig as JFedConfig
from repro.configs.fedar_mnist import fleet_fed as jfleet_fed
from repro.configs.fedar_mnist import small_model as jsmall_model
from repro.core.engine import FedAREngine as JEngine
from repro.core.faults import make_faults as jmake_faults
from repro.core.resources import TaskRequirement as JReq
from repro.data.datasets import corrupt_clients as jcorrupt_clients
from repro.data.datasets import make_federated as jmake_federated
from repro_torch.common.config import FedConfig
from repro_torch.configs.fedar_mnist import fleet_fed, small_model
from repro_torch.convert import GeneratorDraws, ReplayDraws, params_from_jax
from repro_torch.core import compress as tcompress
from repro_torch.core.engine import FedAREngine
from repro_torch.core.faults import FAULT_KEY_FOLD, NoFaults, make_faults
from repro_torch.core.fedar import FedARServer
from repro_torch.core.resources import TaskRequirement
from repro_torch.data.datasets import corrupt_clients, make_federated
from repro_torch.data.federated import table2_fleet

KINDS = ("crash", "corrupt", "battery", "flaky", "chaos")
ROUNDS = 4


@pytest.mark.parametrize("kind", KINDS)
def test_traits_and_draws_bit_equal_to_reference(kind):
    """The static traits are the reference's numpy picks bit for bit, and
    each round's realization from the same coin table is identical."""
    kw = dict(num_clients=48, faults=kind, seed=5)
    ours, theirs = make_faults(FedConfig(**kw)), jmake_faults(JFedConfig(**kw))
    for name in ("corrupt_clients", "flap_clients", "battery_clients"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))
    for name in ("_fill", "_flap_phase", "_batt_phase"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)))
    ids = np.arange(48, dtype=np.int32)
    coins = reference_draws(5, 8, 48, faults=True)["faults"]
    for r in range(8):
        key = jax.random.fold_in(jax.random.PRNGKey(5), r)
        want = theirs.draw(key, jnp.asarray(ids), r)
        got = ours.draw(torch.as_tensor(coins[r]), torch.as_tensor(ids), r)
        for name in want._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=f"round {r} {name}")


@pytest.fixture
def qsgd_level(monkeypatch):
    """The run's largest QSGD level (scale / L), read off every payload the
    port decodes."""
    level = [0.0]
    decode = tcompress.QSGDCompression.decode

    def recording(self, payload, dim):
        level[0] = max(level[0], payload["scale"].max().item() / self.levels)
        return decode(self, payload, dim)

    monkeypatch.setattr(tcompress.QSGDCompression, "decode", recording)
    return level


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["fedar", "async-qsgd4"])
def test_fault_round_matches_live_reference(kind, mode, qsgd_level):
    overrides = dict(faults=kind, defense="foolsgold_sketch")
    if mode != "fedar":
        overrides.update(aggregation="async", compress="qsgd", compress_bits=4)
    jstate, jouts, server, hist = run_both(ROUNDS, **overrides)
    assert_bookkeeping_equal(jstate, jouts, server, hist)
    st = server.state
    np.testing.assert_allclose(st.params.numpy(), np.asarray(jstate.params),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st.fg_history.numpy(), np.asarray(jstate.fg_history),
                               rtol=2e-4, atol=2e-4)
    for name in ("compress_residual", "pending_delta"):
        assert_close_up_to_flips(name, getattr(st, name).numpy(),
                                 np.asarray(getattr(jstate, name)),
                                 level=qsgd_level[0], max_share=1e-4)
    assert np.isfinite(st.params.numpy()).all()


class _NoFaultDraw(ReplayDraws):
    def fault_coins(self, round_idx, n):
        raise AssertionError("faults='none' took a fault draw")


def test_no_faults_takes_no_draw_and_keeps_the_round():
    """``faults="none"`` builds ``NoFaults`` and never asks for coins, and an
    active schedule whose rates and traits fire nothing leaves the round
    unchanged bit for bit."""
    fed = fleet_fed(12, defense="foolsgold_sketch")
    assert isinstance(make_faults(fed), NoFaults)
    draws = reference_draws(0, 3, 12, faults=True)
    data = table2_fleet(samples_per_client=20)

    def run(fed, draws):
        eng = FedAREngine(small_model(8), fed, TaskRequirement(), device="cpu",
                          draws=draws)
        return eng.run(eng.init_state(), data, rounds=3)

    s0, o0 = run(fed, _NoFaultDraw(**draws))
    quiet = fleet_fed(12, defense="foolsgold_sketch", faults="crash",
                      fault_crash_rate=0.0, quarantine_cap=float("inf"))
    s1, o1 = run(quiet, ReplayDraws(**draws))
    for a, b in zip(o0, o1):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for name in ("params", "fg_history"):
        assert torch.equal(getattr(s0, name), getattr(s1, name))


def test_corrupt_clients_match_reference_and_are_quarantined():
    """``corrupt_clients`` writes the reference's garbage shards; a round
    over them matches the reference, and each corrupted client gets exactly
    zero weight (the params stay finite, its trust takes the ban)."""
    which = np.zeros(12, bool)
    which[[1, 4]] = True
    jds = jcorrupt_clients(jmake_federated("table2", 12, samples_per_client=60),
                           which, np.nan)
    ds = corrupt_clients(make_federated("table2", 12, samples_per_client=60),
                         which, np.nan)
    np.testing.assert_array_equal(ds.x, jds.x)
    with pytest.raises(ValueError, match="mask shape"):
        corrupt_clients(ds, which[:5], np.nan)
    jeng = JEngine(jsmall_model(32), jfleet_fed(12, defense="foolsgold_sketch"), JReq())
    jstate, jouts = jeng.run(jeng.init_state(),
                             {k: jnp.asarray(v) for k, v in jds.arrays().items()},
                             rounds=3)
    params, _ = params_from_jax(jeng.template)
    server = FedARServer(small_model(32), fleet_fed(12, defense="foolsgold_sketch"),
                         TaskRequirement(), device="cpu",
                         draws=ReplayDraws(**reference_draws(0, 3, 12)),
                         init_params=params)
    hist = server.run(ds, rounds=3)
    assert_bookkeeping_equal(jstate, jouts, server, hist)
    np.testing.assert_allclose(server.state.params.numpy(), np.asarray(jstate.params),
                               rtol=2e-4, atol=2e-4)
    assert torch.isfinite(server.state.params).all()
    picked = np.stack(hist["selected"])[:, which].any(axis=0)
    assert picked.any()
    assert (server.trust.score.numpy()[which][picked] < 50.0).all()


def test_gated_packed_chaos_matches_reference():
    """Gated packed (``select_frac``) with chaos: the compact cohort view is
    dropped under the schedule, on both sides."""
    kw = dict(scenario="quantity_skew", samples_per_client=60, seed=7)
    fed_kw = dict(defense="foolsgold_sketch", select_frac=0.5, faults="chaos")
    jeng = JEngine(jsmall_model(32), jfleet_fed(12, **fed_kw), JReq())
    jstate, jouts = jeng.run(
        jeng.init_state(),
        jax.tree.map(jnp.asarray,
                     jmake_federated("digits", 12, **kw).packed_arrays(quantum=20)),
        rounds=ROUNDS)
    params, _ = params_from_jax(jeng.template)
    server = FedARServer(small_model(32), fleet_fed(12, **fed_kw), TaskRequirement(),
                         device="cpu",
                         draws=ReplayDraws(**reference_draws(0, ROUNDS, 12, faults=True)),
                         init_params=params)
    hist = server.run(make_federated("digits", 12, **kw).packed_arrays(quantum=20),
                      rounds=ROUNDS)
    assert_bookkeeping_equal(jstate, jouts, server, hist)
    np.testing.assert_allclose(server.state.params.numpy(), np.asarray(jstate.params),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(server.fg_history.numpy(), np.asarray(jstate.fg_history),
                               rtol=2e-4, atol=2e-4)


def test_chaos_soak_stays_finite_with_standalone_draws():
    """24 rounds of chaos on the port's own generator draws: the model
    stays finite and the quarantine brands every corruptor it sees."""
    fed = fleet_fed(12, defense="foolsgold_sketch", faults="chaos")
    eng = FedAREngine(small_model(8), fed, TaskRequirement(), device="cpu")
    assert isinstance(eng.draws, GeneratorDraws)
    coins = eng.draws.fault_coins(3, 12)
    assert coins.shape == (12, 2) and coins.dtype == torch.float32
    assert torch.equal(coins, GeneratorDraws(0).fault_coins(3, 12))
    state, outs = eng.run(eng.init_state(), table2_fleet(samples_per_client=20),
                          rounds=24)
    assert torch.isfinite(state.params).all()
    assert outs.selected.any(dim=1).all()
    assert eng.faults.corrupt_clients.sum() == 3


def test_unknown_schedule_and_key_fold():
    assert FAULT_KEY_FOLD == 0xFA017
    with pytest.raises(ValueError, match="unknown FedConfig.faults"):
        FedAREngine(small_model(8), fleet_fed(12, faults="meteor", defense="none"),
                    TaskRequirement(), device="cpu")
    assert fleet_fed(12, faults="chaos").resolved_quarantine_cap == 1e6
    with pytest.raises(IndexError, match="fault coins"):
        ReplayDraws(**reference_draws(0, 1, 12)).fault_coins(0, 12)
