"""The port's buffered ``async`` and legacy ``async_seq`` modes against the
live reference.

Every trajectory runs the golden-size config (12 robots, Table II with 60
samples each, ``small_model(32)``) for 5 rounds through both engines, with
the reference's init params and replayed draws (``tests/_torch_parity.py``).
Clients 2 and 7 are forced to straggle (latency 3 x timeout, lag 3): the
golden fleet never straggles on its own, and with them the buffer admits,
holds and delivers within the 5 rounds (client 7 at round 3, client 2 at
round 4).  Trust, the masks, the counters and the slot bookkeeping must
match exactly; params and the pending buffer within atol = rtol = 2e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_bookkeeping_equal, run_both

from repro.common.config import FedConfig as JFedConfig
from repro.core import aggregation as jagg
from repro_torch.common.config import FedConfig
from repro_torch.configs.fedar_mnist import fleet_fed, small_model
from repro_torch.core import aggregation as agg
from repro_torch.core.fedar import FedARServer
from repro_torch.core.resources import TaskRequirement
from repro_torch.data.federated import table2_fleet

ROUNDS = 5
FORCE = np.isin(np.arange(12), [2, 7])


@pytest.mark.parametrize("overrides", [
    dict(aggregation="async", defense="none"),
    dict(aggregation="async", defense="none", staleness_decay="const"),
    dict(aggregation="async", defense="foolsgold_sketch"),
    dict(aggregation="async_seq", defense="none"),
], ids=["async-poly", "async-const", "async-sketch", "async_seq"])
def test_async_trajectory_matches_live_reference(overrides):
    jstate, jouts, server, hist = run_both(ROUNDS, force=FORCE, **overrides)
    assert_bookkeeping_equal(jstate, jouts, server, hist)
    st = server.state
    np.testing.assert_allclose(st.params.numpy(), np.asarray(jstate.params),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st.pending_delta.numpy(),
                               np.asarray(jstate.pending_delta),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st.pending_weight.numpy(),
                               np.asarray(jstate.pending_weight),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st.fg_history.numpy(),
                               np.asarray(jstate.fg_history),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(hist["acc"], np.asarray(jouts.acc), atol=2e-4)
    assert hist["round_time"] == [10.0] * ROUNDS  # the timeout, never waits
    if overrides["aggregation"] == "async":
        # the forced stragglers' uploads were buffered with lag 3 and
        # delivered by the last round
        lag = np.asarray(jstate.pending_arrival) - np.asarray(jstate.pending_issued)
        assert (lag[FORCE] == 3).all()
        assert not np.asarray(jstate.pending_valid)[FORCE].any()


def test_buffer_holds_a_straggler_until_it_arrives():
    """A straggler selected again while its upload is in transit keeps its
    slot (issue round and arrival round) until delivery, then the slot
    frees; the slot's delta is the one admitted at issue."""
    fed = fleet_fed(12, aggregation="async", defense="none", local_epochs=1)
    server = FedARServer(small_model(8), fed, TaskRequirement(), device="cpu")
    data = table2_fleet(samples_per_client=40)
    server.run_round(data, force_straggler=FORCE)
    st0 = server.state
    held = st0.pending_valid.numpy()
    assert held.any() and not held[~FORCE].any()
    for _ in range(2):
        server.run_round(data, force_straggler=FORCE)
        st = server.state
        assert st.pending_valid.numpy()[held].all()
        assert torch.equal(st.pending_issued[held], st0.pending_issued[held])
        assert torch.equal(st.pending_delta[held], st0.pending_delta[held])
    server.run_round(data, force_straggler=FORCE)  # arrival round 3
    assert not server.state.pending_valid.numpy()[held].any()


def _fold_inputs(seed=0, n=7, d=11):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(d).astype(np.float32)
    models = rng.standard_normal((n, d)).astype(np.float32)
    weights = rng.random(n).astype(np.float32) * 60
    mask = rng.random(n) < 0.6
    lat = rng.random(n).astype(np.float32) * 20
    order = np.argsort(np.where(mask, lat, np.inf), kind="stable")
    return g, models, weights, mask, order


def test_async_aggregate_matches_reference():
    g, models, weights, mask, order = _fold_inputs()
    jfed, fed = JFedConfig(), FedConfig()
    want = jagg.async_aggregate(jnp.asarray(g), jnp.asarray(models),
                                jnp.asarray(weights), jnp.asarray(mask),
                                jnp.asarray(order), jfed)
    got = agg.async_aggregate(torch.as_tensor(g), torch.as_tensor(models),
                              torch.as_tensor(weights), torch.as_tensor(mask),
                              torch.as_tensor(order), fed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_async_aggregate_carries_nonfinite_models_as_the_reference_does():
    """R6 (ROADMAP.md): the fold mixes raw local models, so a NaN model of a
    masked-out client still poisons the result (0 * NaN = NaN) on both
    sides; the port reproduces it and does not fix it."""
    g, models, weights, mask, order = _fold_inputs(seed=1)
    out = int(np.flatnonzero(~mask)[0])
    models[out, 3] = np.nan
    jfed, fed = JFedConfig(), FedConfig()
    want = np.asarray(jagg.async_aggregate(
        jnp.asarray(g), jnp.asarray(models), jnp.asarray(weights),
        jnp.asarray(mask), jnp.asarray(order), jfed))
    got = agg.async_aggregate(torch.as_tensor(g), torch.as_tensor(models),
                              torch.as_tensor(weights), torch.as_tensor(mask),
                              torch.as_tensor(order), fed).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[3])


@pytest.mark.parametrize("decay", ["poly", "const"])
def test_staleness_weight_matches_reference(decay):
    tau = np.asarray([0.0, 1.0, 3.0, 8.0], np.float32)
    jfed = JFedConfig(staleness_decay=decay)
    fed = FedConfig(staleness_decay=decay)
    want = np.asarray(jagg.staleness_weight(jnp.asarray(tau), jfed))
    np.testing.assert_array_equal(
        agg.staleness_weight(torch.as_tensor(tau), fed).numpy(), want)
    assert want[0] == 1.0


def test_state_widths_follow_the_mode():
    """The (N, D) pending block exists only under ``async``; the other
    modes carry (N, 0), as the reference does."""
    for mode, width in (("async", True), ("async_seq", False), ("fedar", False)):
        eng = FedARServer(small_model(8), fleet_fed(12, aggregation=mode,
                                                    defense="none"),
                          TaskRequirement(), device="cpu").engine
        st = eng.init_state()
        assert st.pending_delta.shape == (12, eng.dim if width else 0)
        assert st.compress_residual.shape == (12, 0)
        assert st.pending_issued.dtype == torch.int32
