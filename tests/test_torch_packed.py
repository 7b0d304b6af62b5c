"""The port's packed, selection-gated and drift paths against the reference.

The reference's Pallas ragged kernel runs in interpret mode on the CPU;
engine runs replay the reference's draws and init params into the port
(``tests/_torch_parity.py``).  Stated tolerances:

- the ragged plain version against the Pallas kernel and against
  ``local_sgd_ref`` per bucket: atol = rtol = 1e-5 (fp32 sums of the
  hand-written and the autodiff gradient in another order, 2 epochs);
- whole runs against the live reference: trust and masks exact, params and
  the defense history within 2e-4 (the goldens' band), 1e-6 on R2's
  2-round example;
- the port's packed path against its dense path: trust and masks exact,
  params within 1e-6 (the same autograd SGD over blocks of other heights);
- gated against full: the reference's own band, 1e-5 (the compact cohort
  sums skip the known-zero rows, which shifts fp32 summation order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import reference_draws

from repro.configs.fedar_mnist import fleet_fed as jfleet_fed
from repro.configs.fedar_mnist import small_model as jsmall_model
from repro.core.engine import FedAREngine as JEngine
from repro.core.resources import TaskRequirement as JReq
from repro.data.datasets import make_federated as jmake_federated
from repro.kernels import ref as jref
from repro.kernels.local_sgd import local_sgd_fused_ragged
from repro_torch.configs.fedar_mnist import fleet_fed, small_model
from repro_torch.convert import ReplayDraws, params_from_jax
from repro_torch.core.engine import FedAREngine, PackedLayout
from repro_torch.core.fedar import FedARServer
from repro_torch.core.resources import TaskRequirement
from repro_torch.data.datasets import make_federated
from repro_torch.data.federated import scaled_fleet
from repro_torch.kernels import ref
from repro_torch.kernels.local_sgd import local_sgd_ragged

SCENARIOS = ("iid", "label_skew", "quantity_skew", "robot_drift")
I, H, C, B, E = 16, 8, 10, 5, 2


# ------------------------------------------------------ the ragged kernel
def ragged_inputs(seed=0):
    """Three buckets of mixed widths (a full tile, a ragged tail, an
    all-padding tile, an all-False dummy row) tiled into one (T, B, I)
    buffer with per-row (nb, off), as the engine's layout does."""
    rng = np.random.default_rng(seed)
    D = H + C + I * H + H * C
    g = (rng.standard_normal(D) * 0.3).astype(np.float32)
    buckets = []
    for rows, width in ((2, 10), (3, 20), (2, 5)):
        x = rng.random((rows, width, I), dtype=np.float32)
        y = rng.integers(0, C, (rows, width)).astype(np.int32)
        m = np.ones((rows, width), bool)
        act = rng.integers(0, 2, rows).astype(np.int32)
        buckets.append([x, y, m, act])
    buckets[0][2][0, 7:] = False  # ragged tail inside the last tile
    buckets[0][2][1] = False  # all-False dummy row
    buckets[1][2][1, 5:10] = False  # an all-padding tile mid-row
    xt = np.concatenate([b[0].reshape(-1, B, I) for b in buckets])
    yt = np.concatenate([b[1].reshape(-1, B) for b in buckets])
    mt = np.concatenate([b[2].reshape(-1, B) for b in buckets])
    act = np.concatenate([b[3] for b in buckets])
    nb = np.concatenate([np.full(b[0].shape[0], b[0].shape[1] // B, np.int32)
                         for b in buckets])
    off = np.concatenate([[0], np.cumsum(nb)[:-1]]).astype(np.int32)
    return g, buckets, (xt, yt, mt, act, nb, off)


def test_ragged_plain_matches_pallas_and_per_bucket():
    g, buckets, arrays = ragged_inputs()
    kw = dict(hidden=H, classes=C, lr=0.1, epochs=E)
    got = ref.local_sgd_ragged_ref(torch.as_tensor(g),
                                   *(torch.as_tensor(a) for a in arrays), **kw)
    # the wrapper on CPU tensors is the plain version, with no launch
    n0 = local_sgd_ragged.launches
    assert torch.equal(local_sgd_ragged(torch.as_tensor(g),
                                        *(torch.as_tensor(a) for a in arrays), **kw),
                       got)
    assert local_sgd_ragged.launches == n0
    p = ref.split_flat(torch.as_tensor(g), I, H, C)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    xt, yt, mt, act, nb, off = (jnp.asarray(a) for a in arrays)
    pallas = local_sgd_fused_ragged(
        jp["w1"], jp["b1"], jp["w2"], jp["b2"], xt, yt, mt, act, nb, off,
        lr=0.1, epochs=E, nb_max=int(np.max(arrays[4])), interpret=True)
    want = np.concatenate([np.asarray(pallas[k]).reshape(len(arrays[3]), -1)
                           for k in ("b1", "b2", "w1", "w2")], 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    r0 = 0
    for x, y, m, a in buckets:
        per = ref.local_sgd_ref(torch.as_tensor(g), torch.as_tensor(x),
                                torch.as_tensor(y), torch.as_tensor(a),
                                torch.as_tensor(m), batch_size=B, **kw)
        np.testing.assert_allclose(got[r0:r0 + len(x)].numpy(), per.numpy(),
                                   atol=1e-5, rtol=1e-5)
        r0 += len(x)
    assert torch.equal(got[1], torch.as_tensor(g))  # the dummy row
    # one client through jref (jax.grad) as a third opinion
    one = jref.local_sgd_ref(jp["w1"], jp["b1"], jp["w2"], jp["b2"],
                             jnp.asarray(buckets[1][0][1]),
                             jnp.asarray(buckets[1][1][1]), int(buckets[1][3][1]),
                             jnp.asarray(buckets[1][2][1]), lr=0.1,
                             batch_size=B, epochs=E)
    np.testing.assert_allclose(got[3, H + C:H + C + I * H].numpy(),
                               np.asarray(one["w1"]).reshape(-1),
                               atol=1e-5, rtol=1e-5)


def test_ragged_plain_no_tiles_keeps_global_row():
    g, _, (xt, yt, mt, act, nb, off) = ragged_inputs(1)
    nb = nb.copy()
    nb[2] = 0
    got = ref.local_sgd_ragged_ref(torch.as_tensor(g), *(torch.as_tensor(a) for a in
                                                         (xt, yt, mt, act, nb, off)),
                                   hidden=H, classes=C, lr=0.1, epochs=E)
    assert torch.equal(got[2], torch.as_tensor(g))
    assert ref.local_sgd_ragged_ref(
        torch.as_tensor(g), torch.as_tensor(xt), torch.as_tensor(yt),
        torch.as_tensor(mt), *(torch.zeros(0, dtype=torch.int32),) * 3,
        hidden=H, classes=C, lr=0.1, epochs=E).shape == (0, len(g))


# ------------------------------------------------------------ engine runs
def reference_run(fed_kw, jdata, rounds, hidden):
    jeng = JEngine(jsmall_model(hidden), jfleet_fed(fed_kw.pop("n"), **fed_kw), JReq())
    jstate, jouts = jeng.run(jeng.init_state(), jax.tree.map(jnp.asarray, jdata),
                             rounds=rounds)
    return jeng, jstate, jouts


def port_run(jeng, fed_kw, data, rounds, hidden):
    n = fed_kw.pop("n")
    params, _ = params_from_jax(jeng.template)
    server = FedARServer(small_model(hidden), fleet_fed(n, **fed_kw),
                         TaskRequirement(), device="cpu",
                         draws=ReplayDraws(**reference_draws(0, rounds, n)),
                         init_params=params)
    hist = server.run(data, rounds=rounds)
    return server, hist


def assert_matches_reference(server, hist, jstate, jouts, tol):
    for key in ("trust", "selected", "on_time"):
        np.testing.assert_array_equal(np.stack(hist[key]),
                                      np.asarray(getattr(jouts, key)), err_msg=key)
    np.testing.assert_array_equal(server.trust.participations.numpy(),
                                  np.asarray(jstate.trust.participations))
    np.testing.assert_allclose(server.state.params.numpy(),
                               np.asarray(jstate.params), rtol=tol, atol=tol)
    np.testing.assert_allclose(server.fg_history.numpy(),
                               np.asarray(jstate.fg_history), rtol=tol, atol=tol)


def test_gated_packed_golden_config_matches_reference():
    """The reference's gated golden config (12 clients, quantity_skew seed 7,
    60 samples, small_model(32), fedar + foolsgold_sketch, select_frac 0.5,
    quantum 20, 5 rounds), live on both sides."""
    kw = dict(scenario="quantity_skew", samples_per_client=60, seed=7)
    fed_kw = dict(n=12, defense="foolsgold_sketch", select_frac=0.5)
    jeng, jstate, jouts = reference_run(
        dict(fed_kw), jmake_federated("digits", 12, **kw).packed_arrays(quantum=20),
        5, 32)
    server, hist = port_run(jeng, dict(fed_kw),
                            make_federated("digits", 12, **kw).packed_arrays(quantum=20),
                            5, 32)
    assert_matches_reference(server, hist, jstate, jouts, 2e-4)


def test_r2_example_packed_matches_reference_dense():
    """ROADMAP R2's recorded example: the port's packed path against the
    reference's DENSE path."""
    kw = dict(scenario="quantity_skew", samples_per_client=33, seed=0)
    fed_kw = dict(n=8, local_epochs=1)
    jeng, jstate, jouts = reference_run(
        dict(fed_kw), jmake_federated("digits", 8, **kw).arrays(), 2, 8)
    server, hist = port_run(jeng, dict(fed_kw),
                            make_federated("digits", 8, **kw).packed_arrays(), 2, 8)
    assert_matches_reference(server, hist, jstate, jouts, 1e-6)


@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_robot_drift_matches_reference(layout):
    """The drift schedule (round t trains on window t mod 4) on both
    layouts, 5 rounds so one window trains twice."""
    kw = dict(scenario="robot_drift", samples_per_client=40, seed=3)
    fed_kw = dict(n=10, defense="foolsgold_sketch", local_epochs=2)
    jds = jmake_federated("digits", 10, **kw)
    tds = make_federated("digits", 10, **kw)
    pick = (lambda d: d.arrays()) if layout == "dense" else (
        lambda d: d.packed_arrays(quantum=20))
    jeng, jstate, jouts = reference_run(dict(fed_kw), pick(jds), 5, 16)
    data = pick(tds)
    assert "round_mask" in (data if layout == "dense" else data["packed"])
    server, hist = port_run(jeng, dict(fed_kw), data, 5, 16)
    assert_matches_reference(server, hist, jstate, jouts, 2e-4)


# --------------------------------------------------- laws on the port alone
def port_engine(n, **kw):
    kw.setdefault("local_epochs", 2)
    return FedAREngine(small_model(8), fleet_fed(n, **kw), TaskRequirement(),
                       device="cpu")


def run(engine, data, rounds=3):
    return engine.run(engine.init_state(), data, rounds=rounds)


def assert_states_close(s0, s1, tol):
    torch.testing.assert_close(s0.params, s1.params, rtol=tol, atol=tol)
    assert torch.equal(s0.trust.score, s1.trust.score)
    torch.testing.assert_close(s0.fg_history, s1.fg_history, rtol=tol, atol=tol)
    assert torch.equal(s0.resources.battery, s1.resources.battery)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_packed_equals_dense(scenario):
    ds = make_federated("digits", 16, scenario=scenario, samples_per_client=30,
                        seed=2)
    engine = port_engine(16, defense="foolsgold_sketch")
    s0, o0 = run(engine, ds.arrays())
    s1, o1 = run(engine, ds.packed_arrays())
    assert_states_close(s0, s1, 1e-6)
    assert torch.equal(o0.selected, o1.selected)
    assert torch.equal(o0.on_time, o1.on_time)


@pytest.mark.parametrize("aggregation", ["fedar", "fedavg", "async", "async_seq"])
@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_gated_equals_full(aggregation, layout):
    """Gating trains only the cohort; unselected clients keep the global
    row, so every mode (async_seq folds the raw local models) is
    unchanged."""
    if layout == "dense":
        data = scaled_fleet(16, samples_per_client=40)
    else:
        data = make_federated("digits", 16, scenario="quantity_skew",
                              samples_per_client=30, seed=4).packed_arrays(quantum=20)
    kw = dict(local_epochs=1, aggregation=aggregation, defense="foolsgold_sketch")
    s0, o0 = run(port_engine(16, **kw), data)
    s1, o1 = run(port_engine(16, select_frac=0.5, **kw), data)
    assert_states_close(s0, s1, 1e-5)
    assert torch.equal(o0.selected, o1.selected)


def test_gated_packed_equals_dense_full():
    ds = make_federated("digits", 16, scenario="quantity_skew",
                        samples_per_client=30, seed=4)
    s0, _ = run(port_engine(16), ds.arrays())
    s1, _ = run(port_engine(16, select_frac=0.5), ds.packed_arrays(quantum=20))
    assert_states_close(s0, s1, 1e-5)


def test_gated_with_compression_drops_compact_view():
    """With QSGD the canonical decoded rows feed every later op, so gating
    changes nothing but which clients train."""
    ds = make_federated("digits", 12, scenario="quantity_skew",
                        samples_per_client=30, seed=1)
    kw = dict(compress="qsgd", compress_bits=8, defense="foolsgold_sketch")
    s0, _ = run(port_engine(12, **kw), ds.packed_arrays(quantum=20))
    s1, _ = run(port_engine(12, select_frac=0.5, **kw), ds.packed_arrays(quantum=20))
    assert_states_close(s0, s1, 1e-5)
    torch.testing.assert_close(s0.compress_residual, s1.compress_residual,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gated", [False, True])
def test_kernel_route_glue_on_cpu(gated):
    """The engine's kernel-route glue (the tile buffer, the per-row nb / off
    tables, the slot rows) with the ragged wrapper computing its plain
    version on CPU tensors, against the plain route (autograd per block):
    the same rows in the same order, within 1e-5."""
    ds = make_federated("digits", 12, scenario="quantity_skew",
                        samples_per_client=45, seed=6)
    kw = dict(defense="foolsgold_sketch", select_frac=0.5 if gated else None)
    plain = port_engine(12, **kw)
    glue = port_engine(12, **kw)
    glue.sgd_route = "kernel"  # the wrapper takes its plain version on the CPU
    data = plain.prepare_data(ds, layout="packed")
    s0, o0 = run(plain, data)
    s1, o1 = run(glue, data)
    assert_states_close(s0, s1, 1e-5)
    assert torch.equal(o0.on_time, o1.on_time)


def test_layout_tables():
    """The tile buffer holds every bucket row's samples at its (nb, off);
    ``inv`` and the descending order cover every row once; the gated plan
    grants min(C, rows) slots widest first."""
    ds = make_federated("digits", 13, scenario="quantity_skew",
                        samples_per_client=50, seed=3)
    raw = ds.packed_arrays(quantum=20)
    lay = port_engine(13, select_frac=0.5).device_data(raw)["packed"]
    assert isinstance(lay, PackedLayout)
    pk = raw["packed"]
    r = 0
    for x, m in zip(pk["x"], pk["mask"]):
        for j in range(x.shape[0]):
            nb, off, L = int(lay.nb[r]), int(lay.off[r]), x.shape[1]
            assert nb == -(-L // 20)
            flat = lay.tiles["x"][off:off + nb].reshape(nb * 20, -1)
            np.testing.assert_array_equal(flat[:L].numpy(), x[j])
            assert not flat[L:].any() and not lay.tile_mask[off:off + nb].reshape(-1)[L:].any()
            np.testing.assert_array_equal(
                lay.tile_mask[off:off + nb].reshape(-1)[:L].numpy(), m[j])
            r += 1
    assert r == lay.act.shape[0]
    assert int(lay.off[-1] + lay.nb[-1]) == lay.tile_mask.shape[0]
    assert sorted(lay.desc_rows.tolist()) == list(range(r))
    assert sorted(lay.perm[lay.inv].tolist()) == list(range(13))
    assert sum(t for _, t in lay.plan) == min(7, r)
    assert [nb for nb, _ in lay.plan] == sorted((nb for nb, _ in lay.plan), reverse=True)
    # a prepared layout passes through device_data without a rebuild, and
    # takes the plan of the engine it reaches
    eng = port_engine(13)
    again = eng.device_data({"packed": lay})["packed"]
    assert again.tiles is lay.tiles and again.plan == ()


def test_validation_and_layout_pick():
    with pytest.raises(ValueError, match="select_frac must be in"):
        port_engine(16, select_frac=1.5)
    with pytest.raises(ValueError, match="caps the SGD cohort"):
        port_engine(16, select_frac=0.25)  # below client_fraction = 0.5
    ds = make_federated("digits", 16, scenario="iid", samples_per_client=20)
    eng = port_engine(16)
    with pytest.raises(ValueError, match="packed data was built for 4"):
        eng.step(eng.init_state(), ds.packed_arrays(shards=4))
    with pytest.raises(ValueError, match="clients"):
        port_engine(12).prepare_data(ds)
    assert "x" in eng.prepare_data(ds)  # iid: dense
    skew = make_federated("digits", 16, scenario="quantity_skew",
                          samples_per_client=60, seed=7)
    assert isinstance(eng.prepare_data(skew)["packed"], PackedLayout)
    # the server takes the dataset itself and prepares it the same way
    server = FedARServer(small_model(8), dataclasses.replace(
        fleet_fed(16, local_epochs=1), select_frac=0.5), TaskRequirement(),
        device="cpu")
    hist = server.run(skew, rounds=2)
    assert len(hist["trust"]) == 2 and torch.isfinite(server.state.params).all()
    # the latency model reads the dense width n_max on both layouts
    assert eng._train_flops(eng.prepare_data(skew)) == eng._train_flops(
        eng.device_data(skew.arrays()))
