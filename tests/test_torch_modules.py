"""The port's round bookkeeping, data and defense modules against the
reference package, on the same numpy inputs made from a seed (CPU).

Integer-granular and mask-valued results (trust, selection, deviation,
fleets, sketch tables) must match exactly; float statistics within the
tolerance each test states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import reference_draws

from repro.common.config import FedConfig as JFedConfig
from repro.core import aggregation as jagg
from repro.core import foolsgold as jfg
from repro.core import resources as jres
from repro.core import trust as jtrust
from repro.core.defense import SketchedFoolsGold as JSketch
from repro.core.selection import select_clients as jselect
from repro.data import federated as jfed_data
from repro.data import synthetic as jsyn
from repro_torch.common.config import FedConfig
from repro_torch.convert import ReplayDraws
from repro_torch.core import aggregation as tagg
from repro_torch.core import foolsgold as tfg
from repro_torch.core import resources as tres
from repro_torch.core import trust as ttrust
from repro_torch.core.defense import SketchedFoolsGold as TSketch
from repro_torch.core.defense import make_defense
from repro_torch.core.selection import select_clients as tselect
from repro_torch.data import federated as tfed_data
from repro_torch.data import synthetic as tsyn


def _t(a):
    return torch.as_tensor(np.array(a))


def test_fed_config_mirrors_reference():
    """Same field names and defaults as the reference's FedConfig."""
    import dataclasses
    ours = {f.name: f.default for f in dataclasses.fields(FedConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JFedConfig)}
    assert ours == theirs
    for defense in (None, "none", "foolsgold_sketch"):
        assert (FedConfig(defense=defense).resolved_defense
                == JFedConfig(defense=defense).resolved_defense)


def test_update_trust_exact():
    """Table I arithmetic over several rounds of random masks: exact."""
    rng = np.random.default_rng(0)
    N = 40
    fed, jfed = FedConfig(), JFedConfig()
    ts, js = ttrust.init_trust(N, fed, "cpu"), jtrust.init_trust(N, jfed)
    for _ in range(12):
        m = {k: rng.random(N) < p for k, p in
             (("selected", 0.6), ("on_time", 0.7), ("deviated", 0.15),
              ("interested", 0.8))}
        ts = ttrust.update_trust(ts, fed, **{k: _t(v) for k, v in m.items()})
        js = jtrust.update_trust(js, jfed, **{k: jnp.asarray(v) for k, v in m.items()})
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ttrust.eligible(ts, fed).numpy(),
                                  np.asarray(jtrust.eligible(js, jfed)))


@pytest.mark.parametrize("n", [12, 512])
def test_make_fleet_bit_equal(n):
    tr, tp = tres.make_fleet(n, seed=3)
    jr, jp = jres.make_fleet(n, seed=3)
    np.testing.assert_array_equal(tp, jp)
    for a, b in zip(tr, jr):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fleets_and_digits_bit_equal():
    a, b = tfed_data.table2_fleet(samples_per_client=60), jfed_data.table2_fleet(
        samples_per_client=60)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype
    (a, am), (b, bm) = (tfed_data.scaled_fleet(30, samples_per_client=40,
                                               return_poisoners=True),
                        jfed_data.scaled_fleet(30, samples_per_client=40,
                                               return_poisoners=True))
    np.testing.assert_array_equal(am, bm)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    for got, want in zip(tsyn.make_digits(50, [1, 7], seed=5, flip_frac=0.3),
                         jsyn.make_digits(50, [1, 7], seed=5, flip_frac=0.3)):
        np.testing.assert_array_equal(got, want)


def test_resource_score_check_resource_latency_battery():
    """CheckResource, the headroom score, the latency (with the
    reference's jitter factor replayed) and the battery drain, exactly."""
    tr, _ = tres.make_fleet(24, seed=1)
    jr, _ = jres.make_fleet(24, seed=1)
    req = tres.TaskRequirement()
    np.testing.assert_array_equal(tres.check_resource(tr, req).numpy(),
                                  np.asarray(jres.check_resource(jr, req)))
    np.testing.assert_array_equal(tres.resource_score(tr, req).numpy(),
                                  np.asarray(jres.resource_score(jr, req)))
    key = jax.random.PRNGKey(7)
    want = jres.round_latency(jr, train_flops=3e8, model_bytes=4e5, key=key)
    # eager, as the eager reference call computes it
    factor = jnp.exp(tres.LATENCY_JITTER * jax.random.normal(key, (24,)))
    got = tres.round_latency(tr, train_flops=3e8, model_bytes=4e5,
                             factor=_t(factor))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    part = np.random.default_rng(2).random(24) < 0.5
    np.testing.assert_array_equal(
        tres.drain_battery(tr, _t(part)).battery.numpy(),
        np.asarray(jres.drain_battery(jr, jnp.asarray(part)).battery))


def test_round_latency_replayed_factor_exact_over_200_rounds():
    """The port's latency with the replayed jitter factor equals the
    reference's jitted ``round_latency`` on all 2,400 client-rounds of the
    12-robot fleet (an ``exp`` of the port's own rounds a few hundred of
    them one ulp away)."""
    tr, _ = tres.make_fleet(12)
    jr, _ = jres.make_fleet(12)
    draws = ReplayDraws(**reference_draws(0, 200, 12))
    ref_lat = jax.jit(lambda res, k: jres.round_latency(
        res, train_flops=3.7e9, model_bytes=407080.0, key=k))
    for r in range(200):
        k_lat = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), r), 3)[1]
        got = tres.round_latency(tr, train_flops=3.7e9, model_bytes=407080.0,
                                 factor=draws.latency_factor(r, 12))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_lat(jr, k_lat)))


def test_select_clients_replayed_gumbel_exact():
    """Trap 1: on the 12-robot fleet several resource scores tie at the
    4.0 cap and every trust score starts at 50, so the pool depends on a
    stable sort.  With the reference's Gumbel draws replayed, selection
    matches exactly over rounds of evolving trust."""
    fed, jfed = FedConfig(), JFedConfig()
    tr, _ = tres.make_fleet(12, seed=0)
    jr, _ = jres.make_fleet(12, seed=0)
    req = tres.TaskRequirement()
    score = tres.resource_score(tr, req)
    assert int((score == 4.0).sum()) >= 6  # the ties are real
    ts, js = ttrust.init_trust(12, fed, "cpu"), jtrust.init_trust(12, jfed)
    rng = np.random.default_rng(0)
    for r in range(8):
        key = jax.random.fold_in(jax.random.PRNGKey(0), r)
        g = jax.random.gumbel(key, (12,))
        sel, ok = tselect(_t(g), ts, tr, req, fed)
        jsel, jok = jselect(key, js, jr, req, jfed)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        on_time = rng.random(12) < 0.8
        ts = ttrust.update_trust(ts, fed, selected=sel, on_time=_t(on_time),
                                 deviated=torch.zeros(12, dtype=torch.bool),
                                 interested=ok)
        js = jtrust.update_trust(js, jfed, selected=jsel,
                                 on_time=jnp.asarray(on_time),
                                 deviated=jnp.zeros(12, bool), interested=jok)


def test_deviation_mask_exact():
    rng = np.random.default_rng(5)
    d = rng.standard_normal((16, 300)).astype(np.float32) * 0.1
    d[3] *= 40.0  # a clear outlier
    d[11] *= 6.0
    active = rng.random(16) < 0.8
    active[3] = True
    got = tagg.deviation_mask(_t(d), _t(active), 1.5)
    want = jagg.deviation_mask(jnp.asarray(d), jnp.asarray(active), 1.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[3]


@pytest.mark.parametrize("impl", ["auto", "einsum"])
def test_fedavg_aggregate_matches_reference(impl):
    """fp32 weighted mean of deltas: atol = rtol = 1e-6."""
    rng = np.random.default_rng(6)
    g = rng.standard_normal(50).astype(np.float32)
    d = rng.standard_normal((8, 50)).astype(np.float32)
    w = rng.random(8).astype(np.float32)
    m = rng.random(8) < 0.6
    got = tagg.fedavg_aggregate(_t(g), _t(d), _t(w), _t(m), impl=impl)
    want = jagg.fedavg_aggregate(jnp.asarray(g), jnp.asarray(d), jnp.asarray(w),
                                 jnp.asarray(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_cluster_weights_even_active_count():
    """Trap 2: with an even number of active clients the reference's
    ``nanmedian`` averages the two middle multiplicities; a lower median
    would change the weights.  Two near-duplicate pairs make the middle
    values differ.  fp32: atol = rtol = 1e-5."""
    rng = np.random.default_rng(7)
    h = rng.standard_normal((8, 64)).astype(np.float32)
    h[1] = h[0] + 0.01 * rng.standard_normal(64).astype(np.float32)
    h[2] = h[0] + 0.02 * rng.standard_normal(64).astype(np.float32)
    h[5] = h[4] + 0.3 * rng.standard_normal(64).astype(np.float32)
    active = np.array([1, 1, 1, 0, 1, 1, 0, 0], bool)  # 4 active
    kw = dict(power=2.0, slack=1.0, sharpness=3.0)
    got = tfg.cluster_weights(_t(h), _t(active), **kw)
    want = jfg.cluster_weights(jnp.asarray(h), jnp.asarray(active), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the two middle multiplicities differ, so the median choice matters
    cs = tfg._similarity_block(_t(h), _t(active), impl="einsum")
    m = (1.0 + (torch.clamp(cs, 0, 1) ** 2.0).sum(1))[_t(active)]
    mid = torch.sort(m).values[1:3]
    assert mid[0] != mid[1]


def test_foolsgold_weights_and_history_match():
    """Dense FoolsGold statistic and the history update: atol = rtol = 1e-5."""
    rng = np.random.default_rng(8)
    h = rng.standard_normal((10, 120)).astype(np.float32)
    h[7] = h[6] * 1.01
    d = rng.standard_normal((10, 120)).astype(np.float32)
    active = rng.random(10) < 0.8
    active[6:8] = True
    np.testing.assert_allclose(
        tfg.foolsgold_weights(_t(h), _t(active)).numpy(),
        np.asarray(jfg.foolsgold_weights(jnp.asarray(h), jnp.asarray(active))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tfg.update_history(_t(h), _t(d), _t(active), decay=0.9).numpy(),
        np.asarray(jfg.update_history(jnp.asarray(h), jnp.asarray(d),
                                      jnp.asarray(active), decay=0.9)),
        rtol=1e-6, atol=1e-6)


def test_count_sketch_tables_bit_equal():
    """The sketch tables are rebuilt bit-for-bit from the seed; the sketch
    itself (a scatter-add in another order) within atol = rtol = 1e-5."""
    fed = FedConfig(defense="foolsgold_sketch", seed=3)
    jfed = JFedConfig(defense="foolsgold_sketch", seed=3)
    ours, theirs = TSketch(fed, 5000, "cpu"), JSketch(jfed, 5000)
    np.testing.assert_array_equal(ours.bucket.numpy(), np.asarray(theirs.bucket))
    np.testing.assert_array_equal(ours.sign.numpy(), np.asarray(theirs.sign))
    assert ours.sign.dtype == torch.float32
    rows = np.random.default_rng(9).standard_normal((4, 5000)).astype(np.float32)
    np.testing.assert_allclose(ours.sketch(_t(rows)).numpy(),
                               np.asarray(theirs.sketch(jnp.asarray(rows))),
                               rtol=1e-5, atol=1e-5)
    assert isinstance(make_defense(fed, 5000), TSketch)
    with pytest.raises(ValueError, match="unknown"):
        make_defense(FedConfig(defense="krum"), 10)
