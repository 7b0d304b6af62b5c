"""The port's host-store cohort engine against the live reference.

``sample_cohort`` and the ``ClientStore`` are numpy on both sides and must
be bit-equal.  ``CohortEngine`` runs a 48-client ``VirtualFleet`` with a
cohort of K = 12 (``small_model(32)``, 60 samples each) through the
reference's and the port's engines, from the reference's init params with
its draws replayed at (seed, round) for the K slots: the cohort, trust,
masks, counters, battery and ``last_selected`` exactly, params, history,
residual and pending buffer within atol = rtol = 2e-4 (up to QSGD code
flips where QSGD is on).
"""
import numpy as np
import pytest
import torch
from _torch_parity import assert_cohort_equal, run_cohort_both

from repro.common.config import FedConfig as JFedConfig
from repro.core.client_store import ClientStore as JClientStore
from repro.core.selection import sample_cohort as jsample_cohort
from repro.core.trust import TrustState as JTrustState
from repro.data.datasets import VirtualFleet as JVirtualFleet
from repro.data.datasets import make_federated as jmake_federated
from repro_torch.common.config import FedConfig
from repro_torch.configs.fedar_mnist import fleet_fed, small_model
from repro_torch.core import compress as tcompress
from repro_torch.core.client_store import ClientStore
from repro_torch.core.engine import CohortEngine, FedAREngine
from repro_torch.core.fedar import FedARServer
from repro_torch.core.resources import TaskRequirement
from repro_torch.core.selection import sample_cohort
from repro_torch.core.trust import TrustState
from repro_torch.data.datasets import VirtualFleet, make_federated

REQ = TaskRequirement()


def _stores(n, seed, **kw):
    fed = dict(num_clients=n, seed=seed, **kw)
    return ClientStore(FedConfig(**fed), 4), JClientStore(JFedConfig(**fed), 4)


@pytest.mark.parametrize("case", ["trust-pool", "underfill", "random", "pool-is-fleet",
                                  "ties"])
def test_sample_cohort_bit_equal(case):
    """Seeded stores, each a regime of the value partition: a trust-sorted
    pool, fewer eligible clients than K, the random baseline, a pool of the
    whole fleet, and a pool threshold inside a run of tied scores."""
    n, k, kw = 500, 32, {}
    rng = np.random.default_rng(11)
    ours, theirs = _stores(n, 3)
    score = (50 + rng.integers(-20, 20, n)).astype(np.float32)
    if case == "underfill":
        score[:] = -1.0
        score[rng.choice(n, 9, replace=False)] = 60.0
    if case == "random":
        kw = dict(selection="random")
    if case == "pool-is-fleet":
        kw = dict(client_fraction=1.0)
    if case == "ties":
        score[:] = 50.0
    for s in (ours, theirs):
        s.score = score.copy()
    fed = FedConfig(num_clients=n, seed=3, **kw)
    jfed = JFedConfig(num_clients=n, seed=3, **kw)
    for r in range(3):
        got = sample_cohort(ours.score, ours.resources_view(), REQ, fed,
                            cohort_size=k, round_idx=r)
        want = jsample_cohort(theirs.score, theirs.resources_view(), REQ, jfed,
                              cohort_size=k, round_idx=r)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got[0].dtype == np.int64
    if case == "underfill":
        assert got[1].sum() == 9 and (got[0][~got[1]] == 0).all()


def test_client_store_matches_reference():
    """The fleet columns, ``gather``, ``scatter_round`` (underfill slots
    never land) and ``finish_round`` (interest credit, battery trickle,
    ``last_selected``, the round counter) equal the reference's."""
    ours, theirs = _stores(64, 2, num_starved=5, num_poisoners=7)
    np.testing.assert_array_equal(ours.poison_mask, theirs.poison_mask)
    idx = np.array([1, 5, 9, 30, 0])
    valid = np.array([True, True, True, True, False])
    rng = np.random.default_rng(0)
    rows = ours.gather(idx)
    assert set(rows) == set(theirs.gather(idx))
    upd = dict(score=rows["score"] + 8.0, participations=rows["participations"] + 1,
               failures=rows["failures"] + np.int32(idx % 2),
               battery=rows["battery"] - 0.02,
               history=rng.standard_normal((5, 4)).astype(np.float32))
    for store, ts in ((ours, TrustState), (theirs, JTrustState)):
        store.scatter_round(idx, valid, trust=ts(upd["score"], upd["participations"],
                                                 upd["failures"]),
                            battery=upd["battery"], history=upd["history"])
        elig = np.arange(64) % 3 == 0
        store.finish_round(idx, valid, elig)
        store.finish_round(idx[:2], valid[:2], ~elig)
    got, want = ours.state_dict(), theirs.state_dict()
    assert list(got) == list(want)
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        assert got[name].dtype == want[name].dtype, name
    assert ours.score[0] == theirs.score[0]  # the underfill slot did not land
    assert int(ours.round_idx) == 2


def test_store_blocks_state_dict_and_bytes():
    store = ClientStore(fleet_fed(32, num_starved=0), 4, residual_dim=3,
                        num_shards=4)
    blk = store.block(2)
    blk["score"][:] = 7.0
    assert (store.score[16:24] == 7.0).all() and (store.score[:16] == 50.0).all()
    with pytest.raises(IndexError):
        store.block(4)
    with pytest.raises(ValueError, match="num_shards"):
        ClientStore(fleet_fed(30), 4, num_shards=4)
    other = ClientStore(fleet_fed(32), 4, residual_dim=3)
    other.load_state_dict(store.state_dict())
    np.testing.assert_array_equal(other.score, store.score)
    assert other.score is not store.score
    state = store.state_dict()
    state["history"] = np.zeros((32, 5), np.float32)
    with pytest.raises(ValueError, match="history"):
        other.load_state_dict(state)
    assert store.nbytes == sum(v.nbytes for k, v in store.state_dict().items()
                               if k != "round_idx")


def test_cohort_arrays_match_reference():
    """A masked drift fleet's cohort, underfill slots inert whichever row
    their index points at."""
    kw = dict(scenario="robot_drift", samples_per_client=30, seed=2)
    ds, jds = make_federated("digits", 12, **kw), jmake_federated("digits", 12, **kw)
    valid = np.array([True, True, True, False, False])
    for idx in (np.array([0, 5, 7, 1, 2]), np.array([0, 5, 7, 9, 11])):
        got, want = ds.cohort_arrays(idx, valid), jds.cohort_arrays(idx, valid)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    assert not got["mask"][3:].any() and (got["sizes"][3:] == 0).all()
    dense = make_federated("table2", 12, samples_per_client=20).cohort_arrays([3, 4])
    assert dense["mask"].all() and dense["cohort_valid"].all()


def test_virtual_fleet_matches_reference():
    fleet = VirtualFleet(1000, samples_per_client=20, device="cpu")
    jfleet = JVirtualFleet(1000, samples_per_client=20)
    np.testing.assert_array_equal(fleet.poisoners, jfleet.poisoners)
    idx = np.array([3, 17, 500, 990, 999, 0])
    valid = np.array([True] * 5 + [False])
    got, want = fleet.cohort_arrays(idx, valid), jfleet.cohort_arrays(idx, valid)
    assert set(got) == set(want)
    for key in want:
        assert got[key].device.type == "cpu"
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    small, jsmall = VirtualFleet(30, samples_per_client=20, device="cpu"), \
        JVirtualFleet(30, samples_per_client=20)
    a, b = small.materialize(), jsmall.materialize()
    for key in ("x", "y", "sizes", "activations", "poisoners"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)
    with pytest.raises(ValueError, match="exceeds"):
        VirtualFleet(10, num_poisoners=11, device="cpu")


@pytest.mark.parametrize("overrides", [
    dict(defense="foolsgold_sketch"),
    dict(defense="foolsgold_sketch", aggregation="async", compress="qsgd",
         compress_bits=4, faults="chaos"),
], ids=["fedar-sketch", "async-qsgd4-chaos"])
def test_cohort_engine_matches_live_reference(overrides, monkeypatch):
    level = [0.0]
    decode = tcompress.QSGDCompression.decode

    def recording(self, payload, dim):
        level[0] = max(level[0], payload["scale"].max().item() / self.levels)
        return decode(self, payload, dim)

    monkeypatch.setattr(tcompress.QSGDCompression, "decode", recording)
    jeng, jouts, eng, outs = run_cohort_both(4, **overrides)
    assert_cohort_equal(jeng, jouts, eng, outs,
                        level=level[0] if "compress" in overrides else None)
    assert all(o.selected.any() for _, _, o in outs)
    assert (eng.store.last_selected >= 0).sum() > 12
    if "faults" in overrides:
        assert eng.store.pending_dim == eng.dim and eng.faults.num_clients == 12


def test_cohort_k_geq_n_is_the_resident_engine():
    """``cohort_size >= N``: the server drops the knob and the run is the
    resident engine's, bit for bit, on the materialized fleet."""
    fleet = VirtualFleet(12, samples_per_client=20, device="cpu")
    runs = []
    for k in (None, 12, 40):
        server = FedARServer(small_model(8), fleet_fed(12, defense="foolsgold_sketch",
                                                       cohort_size=k),
                             REQ, device="cpu")
        assert not server.cohort_mode and server.fed.cohort_size is None
        server.run(fleet, rounds=2)
        runs.append(server.state)
    for st in runs[1:]:
        assert torch.equal(st.params, runs[0].params)
        assert torch.equal(st.trust.score, runs[0].trust.score)


@pytest.mark.parametrize("overrides,match", [
    (dict(aggregation="async_seq"), "async_seq"),
    (dict(select_frac=0.5), "select_frac"),
    (dict(cohort_size=48), "whole fleet"),
    (dict(defense="foolsgold"), "cohort-compatible"),
    (dict(cohort_size=None), "cohort_size set"),
])
def test_cohort_engine_config_errors(overrides, match):
    kw = dict(cohort_size=12, defense="foolsgold_sketch")
    kw.update(overrides)
    with pytest.raises(ValueError, match=match):
        CohortEngine(small_model(8), fleet_fed(48, **kw), REQ, device="cpu")


def test_cohort_server_history_and_views():
    """Cohort mode through ``FedARServer``: cohort-indexed history rows, the
    views read from the store, and the resident-only straggler hook
    refused; the device inputs are shaped by K alone."""
    fleet = VirtualFleet(200, samples_per_client=20, device="cpu")
    server = FedARServer(small_model(8), fleet_fed(200, cohort_size=16,
                                                   defense="foolsgold_sketch",
                                                   faults="chaos"),
                         REQ, device="cpu")
    assert server.cohort_mode and server.state is None
    server.engine.timings = {}
    hist = server.run(fleet, rounds=3)
    assert len(hist["cohort"]) == 3 and hist["trust"][0].shape == (16,)
    assert set(server.engine.timings) == set(CohortEngine.PARTS)
    assert all(len(v) == 3 for v in server.engine.timings.values())
    assert server.round_idx == 3 and server.trust.score.shape == (200,)
    assert server.fg_history.shape == (200, 256)
    assert server.resources.battery is server.engine.store.battery
    assert set(server.params) == {"b1", "b2", "w1", "w2"}
    data = fleet.cohort_arrays(*hist["cohort"][0])
    assert data["x"].shape == (16, 20, 784)
    with pytest.raises(ValueError, match="force_straggler"):
        server.run_round(fleet, force_straggler=np.zeros(16, bool))
    with pytest.raises(ValueError, match="fleet has"):
        server.engine.run(VirtualFleet(100, device="cpu"), rounds=1)


def test_cohort_valid_preselects_on_the_resident_engine():
    """``cohort_valid`` in the data dict is the selection: no Gumbel draw is
    taken and exactly the valid slots train."""
    class NoGumbel:
        def __init__(self, inner):
            self.inner = inner

        def gumbel(self, r, n):
            raise AssertionError("cohort_valid must skip the Gumbel draw")

        def __getattr__(self, name):
            return getattr(self.inner, name)

    eng = FedAREngine(small_model(8), fleet_fed(12, defense="none"), REQ, device="cpu")
    eng.draws = NoGumbel(eng.draws)
    data = make_federated("table2", 12, samples_per_client=20).cohort_arrays(
        np.arange(12), np.arange(12) % 3 == 0)
    _, out = eng.step(eng.init_state(), data)
    np.testing.assert_array_equal(out.selected.numpy(), np.arange(12) % 3 == 0)


def test_fleet_and_cohort_engine_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        VirtualFleet(100)
    with pytest.raises(RuntimeError, match="CUDA"):
        CohortEngine(small_model(8), fleet_fed(48, cohort_size=12,
                                               defense="foolsgold_sketch"), REQ)
