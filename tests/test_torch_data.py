"""The port's data layer against the reference's, array for array (CPU).

Both packages build their fleets with numpy from the same seeds, so every
array must be equal (``np.array_equal``), not merely close: the bucket-width
model, the layout pick, the scenario plans behind ``make_federated``, the
padded and packed layouts and the engine dict under each layout.
"""
import numpy as np
import pytest

from repro.data import datasets as jds
from repro.data import federated as jfed
from repro.data import scenarios as jsc
from repro_torch.data import datasets as tds
from repro_torch.data import federated as tfed
from repro_torch.data import scenarios as tsc

SIZE_VECTORS = [
    [1, 1, 1, 1],
    [60, 60, 60, 60],
    [3, 17, 40, 200, 33, 1],
    [1394, 140, 20, 5, 700, 21, 19],
    [16, 15, 17, 31, 32, 33, 64, 65],
]
SCENARIOS = ("iid", "label_skew", "quantity_skew", "robot_drift")


def assert_tree_equal(got, want, path="data"):
    """Nested dicts / tuples of arrays: same keys, lengths, dtypes, values."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{path}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype, f"{path}: {g.dtype} vs {w.dtype}"
        assert np.array_equal(g, w), path


def assert_datasets_equal(got, want):
    for name in ("x", "y", "sizes", "activations", "mask", "round_mask",
                 "poisoners"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            assert_tree_equal(g, w, name)
    assert (got.name, got.scenario, got.num_classes, got.meta) == (
        want.name, want.scenario, want.num_classes, want.meta)


@pytest.mark.parametrize("counts", SIZE_VECTORS)
@pytest.mark.parametrize("quantum", [None, 20])
def test_width_model_and_layout_pick(counts, quantum):
    for min_width in (1, 16):
        kw = dict(min_width=min_width, quantum=quantum)
        assert_tree_equal(tsc.bucket_widths(counts, **kw),
                          jsc.bucket_widths(counts, **kw))
        assert tsc.padding_waste(counts, **kw) == jsc.padding_waste(counts, **kw)
        assert tsc.pick_layout(counts, **kw) == jsc.pick_layout(counts, **kw)
    assert tsc.LAYOUT_WASTE_THRESHOLD == jsc.LAYOUT_WASTE_THRESHOLD


def test_partitions_and_sizes():
    y = np.random.default_rng(0).integers(0, 10, 500)
    for alpha, seed in ((0.5, 0), (0.05, 3), (1e-9, 4)):
        assert_tree_equal(tfed.dirichlet_partition(None, y, 7, alpha, seed),
                          jfed.dirichlet_partition(None, y, 7, alpha, seed))
    for seed in (0, 5):
        want = jsc.quantity_sizes(333, 11, 1.0, np.random.default_rng(seed))
        got = tsc.quantity_sizes(333, 11, 1.0, np.random.default_rng(seed))
        assert_tree_equal(got, want)
    with pytest.raises(ValueError, match="alpha"):
        tfed.dirichlet_partition(None, y, 3, alpha=0.0)


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("seed", [0, 7])
def test_pool_fleets_equal(scenario, seed):
    kw = dict(scenario=scenario, samples_per_client=37, seed=seed)
    got = tds.make_federated("digits", 9, **kw)
    want = jds.make_federated("digits", 9, **kw)
    assert_datasets_equal(got, want)
    assert_tree_equal(got.client_extents(), want.client_extents())
    assert_datasets_equal(got.padded_to(4), want.padded_to(4))


def test_legacy_builders_equal():
    assert_datasets_equal(tds.make_federated("table2", 12, samples_per_client=30),
                          jds.make_federated("table2", 12, samples_per_client=30))
    assert_datasets_equal(
        tds.make_federated("scaled", 14, samples_per_client=25, seed=2),
        jds.make_federated("scaled", 14, samples_per_client=25, seed=2))
    ds = tds.make_federated("table2", 12, samples_per_client=30)
    assert_tree_equal(ds.client_extents(),
                      jds.make_federated("table2", 12, samples_per_client=30
                                         ).client_extents())


@pytest.mark.parametrize("scenario,n,samples", [
    ("quantity_skew", 13, 60), ("robot_drift", 10, 24), ("iid", 8, 20),
    ("label_skew", 12, 40),
])
@pytest.mark.parametrize("quantum", [None, 20])
@pytest.mark.parametrize("shards", [1, 3])
def test_packed_layout_equal(scenario, n, samples, quantum, shards):
    kw = dict(scenario=scenario, samples_per_client=samples, seed=3)
    got = tds.make_federated("digits", n, **kw).packed_arrays(
        shards=shards, quantum=quantum)
    want = jds.make_federated("digits", n, **kw).packed_arrays(
        shards=shards, quantum=quantum)
    assert_tree_equal(got, want)
    if scenario == "robot_drift":
        assert "round_mask" in got["packed"]


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("layout", ["auto", "dense", "packed"])
def test_engine_arrays_equal(scenario, layout):
    kw = dict(scenario=scenario, samples_per_client=30, seed=5)
    got = tds.make_federated("digits", 10, **kw).engine_arrays(
        quantum=20, layout=layout)
    want = jds.make_federated("digits", 10, **kw).engine_arrays(
        quantum=20, layout=layout)
    assert_tree_equal(got, want)


def test_unported_pieces_raise():
    with pytest.raises(NotImplementedError, match="item 13"):
        tds.make_federated("mnist", 12)
    with pytest.raises(NotImplementedError, match="item 13"):
        tds.make_federated("sybil", 12)
    ds = tds.make_federated("digits", 6, scenario="iid", samples_per_client=10)
    with pytest.raises(ValueError, match="layout"):
        ds.engine_arrays(layout="ragged")
