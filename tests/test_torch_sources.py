"""The port's IDX loader, sample sources, sybil fleet and ``DataConfig`` /
``make_data`` against the live reference, byte for byte (CPU).

Both packages parse the same IDX files and draw with numpy from the same
seeds, so every array must be equal in dtype and value
(``np.array_equal``), not merely close.  The IDX files are written here
into a temp dir, plain and gzipped, at the top level and under
``<name>/``; no real MNIST file is needed or fetched.  The last test runs
the sybil fleet through both engines with the reference's draws replayed.
"""
import dataclasses
import gzip
import struct

import numpy as np
import pytest

from repro.configs import fedar_mnist as jcfg
from repro.data import datasets as jds
from repro.data import federated as jfed
from repro.data import sources as jsrc
from repro_torch.configs import fedar_mnist as tcfg
from repro_torch.data import datasets as tds
from repro_torch.data import federated as tfed
from repro_torch.data import sources as tsrc

from _idx_files import DTYPE_CODES, digits_idx, idx_bytes, write_cache, write_split
from test_torch_data import assert_datasets_equal, assert_tree_equal

def assert_same_error(exc, fn_t, fn_j, *args, **kw):
    with pytest.raises(exc) as got:
        fn_t(*args, **kw)
    with pytest.raises(exc) as want:
        fn_j(*args, **kw)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------- constants

def test_tables_match_the_reference():
    assert {k: np.dtype(v) for k, v in tsrc.IDX_DTYPES.items()} == {
        k: np.dtype(v) for k, v in jsrc.IDX_DTYPES.items()}
    assert tsrc.IDX_FILES == jsrc.IDX_FILES
    assert tsrc._FALLBACK_OFFSETS == jsrc._FALLBACK_OFFSETS == {
        "mnist": 1013, "emnist": 2027}


def test_default_cache_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("FEDAR_DATA_DIR", str(tmp_path))
    assert tsrc.default_cache_dir() == jsrc.default_cache_dir() == str(tmp_path)
    monkeypatch.delenv("FEDAR_DATA_DIR")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert tsrc.default_cache_dir() == jsrc.default_cache_dir() == str(
        tmp_path / "home" / ".cache" / "fedar")


# ------------------------------------------------------------- the parser

@pytest.mark.parametrize("dtype", list(DTYPE_CODES), ids=lambda t: t.__name__)
def test_parse_idx_each_dtype(dtype):
    rng = np.random.default_rng(3)
    arr = (rng.standard_normal((3, 5, 7)) * 100).astype(dtype)
    raw = idx_bytes(arr)
    got, want = tsrc.parse_idx(raw), jsrc.parse_idx(raw)
    assert_tree_equal(got, want)
    assert np.array_equal(got, arr)
    # a 1-D payload (labels) and trailing bytes past the body
    lab = np.arange(9).astype(dtype)
    assert_tree_equal(tsrc.parse_idx(idx_bytes(lab) + b"\x00\x01"),
                      jsrc.parse_idx(idx_bytes(lab) + b"\x00\x01"))


@pytest.mark.parametrize("raw", [
    b"\x00\x00\x08",  # truncated before the magic
    struct.pack(">HBB", 0x0102, 0x08, 1) + struct.pack(">I", 1) + b"\x00",
    struct.pack(">HBB", 0, 0x0A, 1) + struct.pack(">I", 1) + b"\x00",
    idx_bytes(np.zeros((4, 4), np.int16))[:-3],  # body shorter than the dims
], ids=["truncated", "bad-magic", "unknown-dtype", "short-body"])
def test_parse_idx_rejects_malformed(raw):
    assert_same_error(ValueError, tsrc.parse_idx, jsrc.parse_idx, raw)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_read_idx_plain_and_gz(tmp_path, gz):
    arr = np.arange(60, dtype=np.int32).reshape(3, 4, 5)
    path = tmp_path / ("a.idx" + (".gz" if gz else ""))
    raw = idx_bytes(arr)
    path.write_bytes(gzip.compress(raw) if gz else raw)
    assert_tree_equal(tsrc.read_idx(str(path)), jsrc.read_idx(str(path)))


def test_find_order(tmp_path):
    """The top level before ``<name>/``, and ``""`` before ``".gz"``."""
    fname = "train-images-idx3-ubyte"

    def both():
        got = tsrc._find(str(tmp_path), "mnist", fname)
        assert got == jsrc._find(str(tmp_path), "mnist", fname)
        return got

    assert both() is None
    (tmp_path / "mnist").mkdir()
    for where in (tmp_path / "mnist" / (fname + ".gz"),
                  tmp_path / "mnist" / fname,
                  tmp_path / (fname + ".gz"),
                  tmp_path / fname):
        where.write_bytes(b"")
        assert both() == str(where)


# --------------------------------------------------------- load_idx_split

@pytest.mark.parametrize("gz,subdir", [(False, False), (True, False),
                                       (False, True), (True, True)],
                         ids=["plain-top", "gz-top", "plain-sub", "gz-sub"])
@pytest.mark.parametrize("name", ["mnist", "emnist"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_load_idx_split(tmp_path, gz, subdir, name, split):
    stored = write_cache(tmp_path, gz=gz, subdir=subdir)
    got = tsrc.load_idx_split(name, split, cache_dir=str(tmp_path))
    want = jsrc.load_idx_split(name, split, cache_dir=str(tmp_path))
    assert_tree_equal(got, want)
    imgs, labels = stored[(name, split)]
    # EMNIST's transpose undone before the flatten: rows in MNIST order
    assert np.array_equal(got[0], imgs.reshape(len(imgs), -1).astype(np.float32) / 255.0)
    assert np.array_equal(got[1], labels.astype(np.int32))


def test_load_idx_split_missing_unknown_and_mismatch(tmp_path, monkeypatch):
    write_cache(tmp_path, names=("mnist",), splits=("train",))
    for name, split in (("mnist", "test"), ("emnist", "train")):
        assert tsrc.load_idx_split(name, split, cache_dir=str(tmp_path)) is None
        assert jsrc.load_idx_split(name, split, cache_dir=str(tmp_path)) is None
    # one of the pair missing is a cold cache too
    write_split(tmp_path, "emnist", "train", *digits_idx(4, 0), subdir=True)
    (tmp_path / "emnist" / jsrc.IDX_FILES[("emnist", "train")][1]).unlink()
    assert tsrc.load_idx_split("emnist", "train", cache_dir=str(tmp_path)) is None
    assert jsrc.load_idx_split("emnist", "train", cache_dir=str(tmp_path)) is None
    assert_same_error(KeyError, tsrc.load_idx_split, jsrc.load_idx_split,
                      "mnist", "validation", cache_dir=str(tmp_path))
    assert_same_error(KeyError, tsrc.load_idx_split, jsrc.load_idx_split,
                      "fashion", "train", cache_dir=str(tmp_path))
    bad = tmp_path / "bad"
    imgs, labels = digits_idx(6, 1)
    for what in ((imgs, labels[:5]), (imgs[:, 0], labels), (imgs, labels[:, None])):
        write_split(bad, "mnist", "train", *what)
        assert_same_error(ValueError, tsrc.load_idx_split, jsrc.load_idx_split,
                          "mnist", "train", cache_dir=str(bad))
    # no cache_dir: $FEDAR_DATA_DIR
    monkeypatch.setenv("FEDAR_DATA_DIR", str(tmp_path))
    assert_tree_equal(tsrc.load_idx_split("mnist"), jsrc.load_idx_split("mnist"))


# ------------------------------------------------------------ ArraySource

@pytest.fixture
def pools(tmp_path):
    write_cache(tmp_path, n=150)
    return {name: (tsrc.get_source(name, cache_dir=str(tmp_path)),
                   jsrc.get_source(name, cache_dir=str(tmp_path)))
            for name in ("mnist", "emnist")}


@pytest.mark.parametrize("name", ["mnist", "emnist"])
@pytest.mark.parametrize("n,classes,flip", [
    (40, None, 0.0),
    (12, [3, 4], 0.0),
    (400, None, 0.0),  # beyond the 150-sample pool
    (50, [0, 1, 2, 3], 0.0),  # beyond the 60-sample class pool
    (90, None, 0.6),
    (70, [5, 6, 8], 0.3),
])
def test_array_source_sample(pools, name, n, classes, flip):
    t, j = pools[name]
    assert isinstance(t, tsrc.ArraySource) and not t.fallback
    assert (t.name, len(t), t.num_classes) == (j.name, len(j), j.num_classes)
    for seed in (0, 5, 123):
        assert_tree_equal(t.sample(n, classes, seed=seed, flip_frac=flip),
                          j.sample(n, classes, seed=seed, flip_frac=flip))


def test_array_source_edges():
    x = np.zeros((6, 784), np.float32)
    y = np.array([0, 1, 2, 0, 1, 2], np.int32)
    t, j = tsrc.ArraySource("tiny", x, y), jsrc.ArraySource("tiny", x, y)
    assert t.num_classes == j.num_classes == 3
    assert_same_error(ValueError, t.sample, j.sample, 4, [7])
    empty = np.zeros((0,), np.int32)
    assert tsrc.ArraySource("e", x[:0], empty).num_classes == 10


# ------------------------------------------------ get_source / eval_source

def test_get_source_fallback(tmp_path, monkeypatch):
    for name in ("mnist", "emnist"):
        t = tsrc.get_source(name, cache_dir=str(tmp_path))
        j = jsrc.get_source(name, cache_dir=str(tmp_path))
        assert isinstance(t, tsrc.SyntheticSource) and t.fallback
        assert (t.name, t.seed_offset) == (j.name, j.seed_offset) == (
            f"{name}-fallback", jsrc._FALLBACK_OFFSETS[name])
        assert_tree_equal(t.sample(33, [1, 7], seed=4, flip_frac=0.5),
                          j.sample(33, [1, 7], seed=4, flip_frac=0.5))
    for name in ("synthetic", "digits"):
        t = tsrc.get_source(name)
        assert not t.fallback and t.seed_offset == 0
    assert_same_error(KeyError, tsrc.get_source, jsrc.get_source, "imagenet")
    # with no cache_dir the loader reads $FEDAR_DATA_DIR
    write_cache(tmp_path / "env", names=("emnist",), splits=("test",))
    monkeypatch.setenv("FEDAR_DATA_DIR", str(tmp_path / "env"))
    t, j = tsrc.get_source("emnist", split="test"), jsrc.get_source("emnist", split="test")
    assert isinstance(t, tsrc.ArraySource)
    assert_tree_equal((t.x, t.y), (j.x, j.y))
    assert tsrc.get_source("emnist").fallback and jsrc.get_source("emnist").fallback


@pytest.mark.parametrize("cached", [("train", "test"), ("train",), ("test",), ()],
                         ids=["both", "train-only", "test-only", "none"])
@pytest.mark.parametrize("name", ["mnist", "emnist"])
def test_eval_source_warnings(tmp_path, cached, name):
    if cached:
        write_cache(tmp_path, names=(name,), splits=cached)
    train = tsrc.get_source(name, cache_dir=str(tmp_path))
    src, warn = tsrc.eval_source(name, train.fallback, cache_dir=str(tmp_path))
    jtrain = jsrc.get_source(name, cache_dir=str(tmp_path))
    jsrc_, jwarn = jsrc.eval_source(name, jtrain.fallback, cache_dir=str(tmp_path))
    assert warn == jwarn
    assert (warn is None) == (len(cached) != 1)
    assert src.fallback == jsrc_.fallback == ("test" not in cached)
    assert_tree_equal(src.sample(25, seed=99), jsrc_.sample(25, seed=99))
    assert tsrc.eval_source("synthetic", True)[1] is None


# ------------------------------------------------------------ sybil fleet

SYBIL_CASES = [  # (N, num_sybils, seed, flip_frac, target_shift)
    (16, 4, 0, 1.0, 1),
    (24, 0, 3, 1.0, 1),
    (20, 7, 1, 0.5, 3),
    (13, 13, 2, 0.25, 9),
]


@pytest.mark.parametrize("source", ["synthetic", "mnist"])
@pytest.mark.parametrize("case", SYBIL_CASES, ids=str)
def test_sybil_fleet(tmp_path, source, case):
    N, k, seed, flip, shift = case
    write_cache(tmp_path, n=200, names=("mnist",))
    kw = dict(seed=seed, samples_per_client=30, flip_frac=flip, target_shift=shift)
    tsource = jsource = None
    if source != "synthetic":
        tsource = tsrc.get_source(source, cache_dir=str(tmp_path))
        jsource = jsrc.get_source(source, cache_dir=str(tmp_path))
        assert isinstance(tsource, tsrc.ArraySource)
    got = tfed.sybil_fleet(N, k, source=tsource, **kw)
    want = jfed.sybil_fleet(N, k, source=jsource, **kw)
    assert_tree_equal(got, want)
    data, mask = got
    assert mask.sum() == k and mask[N - k:].all()
    if k:
        assert (data["activations"][mask] == 1).all()
        assert (data["x"][mask] == data["x"][N - 1]).all()
    fleet_kw = dict(kw, source=source, cache_dir=str(tmp_path))
    assert_datasets_equal(tds.make_federated("sybil", N, num_sybils=k, **fleet_kw),
                          jds.make_federated("sybil", N, num_sybils=k, **fleet_kw))


def test_sybil_builder_defaults(tmp_path):
    got = tds.make_federated("sybil", 20, samples_per_client=12,
                             cache_dir=str(tmp_path))
    want = jds.make_federated("sybil", 20, samples_per_client=12,
                              cache_dir=str(tmp_path))
    assert_datasets_equal(got, want)
    assert got.meta == {"source": "synthetic", "num_sybils": 5}
    assert got.poisoners.sum() == 5 and not got.fallback
    fb = tds.make_federated("sybil", 12, samples_per_client=12, source="emnist",
                            cache_dir=str(tmp_path))
    assert fb.fallback and fb.meta["source"] == "emnist-fallback"
    assert_datasets_equal(fb, jds.make_federated(
        "sybil", 12, samples_per_client=12, source="emnist", cache_dir=str(tmp_path)))


# ------------------------------------------------------ the pool datasets

@pytest.mark.parametrize("cached", [True, False], ids=["cached", "fallback"])
@pytest.mark.parametrize("name", ["mnist", "emnist"])
@pytest.mark.parametrize("scenario", ["iid", "label_skew", "quantity_skew", "robot_drift"])
def test_pool_datasets(tmp_path, cached, name, scenario):
    if cached:
        write_cache(tmp_path, n=400)
    kw = dict(scenario=scenario, samples_per_client=25, seed=2,
              cache_dir=str(tmp_path))
    got = tds.make_federated(name, 10, **kw)
    want = jds.make_federated(name, 10, **kw)
    assert_datasets_equal(got, want)
    assert got.fallback == want.fallback == (not cached)
    assert got.meta["pool_size"] == (400 if cached else 2048)
    assert_tree_equal(got.engine_arrays(quantum=20), want.engine_arrays(quantum=20))


@pytest.mark.parametrize("builder", ["table2", "scaled"])
def test_legacy_builders_on_idx_sources(tmp_path, builder):
    write_cache(tmp_path, n=300)
    n = 12
    kw = dict(samples_per_client=20, source="emnist", cache_dir=str(tmp_path))
    got, want = (m.make_federated(builder, n, **kw) for m in (tds, jds))
    assert_datasets_equal(got, want)
    assert not got.fallback and got.meta == {"source": "emnist"}


# ------------------------------------------------- DataConfig / make_data

def test_data_config_fields_and_defaults():
    t = [(f.name, f.type, f.default) for f in dataclasses.fields(tcfg.DataConfig)]
    j = [(f.name, f.type, f.default) for f in dataclasses.fields(jcfg.DataConfig)]
    assert t == j
    assert dataclasses.asdict(tcfg.DATA) == dataclasses.asdict(jcfg.DATA)
    with pytest.raises(dataclasses.FrozenInstanceError):
        tcfg.DATA.seed = 1


@pytest.mark.parametrize("n,fields", [
    (8, dict(dataset="emnist", scenario="quantity_skew", samples_per_client=30,
             alpha=0.4)),
    (24, dict(dataset="scaled", samples_per_client=40)),
    (10, dict(dataset="digits", scenario="robot_drift", samples_per_client=30,
              alpha=0.3, drift_windows=3, seed=4)),
    (9, dict(dataset="digits", scenario="iid", samples_per_client=15)),
    (12, dict(dataset="table2", samples_per_client=20, source="mnist")),
    (16, dict(dataset="sybil", samples_per_client=20, source="mnist", seed=2)),
    (8, dict(dataset="mnist", scenario="label_skew", samples_per_client=20)),
], ids=["emnist-quantity", "scaled", "drift", "iid", "table2-mnist",
        "sybil-mnist", "mnist-cached"])
def test_make_data(tmp_path, n, fields):
    write_cache(tmp_path, n=300, names=("mnist",))
    fields = dict(fields, cache_dir=str(tmp_path))
    got = tcfg.make_data(n, tcfg.DataConfig(**fields))
    want = jcfg.make_data(n, jcfg.DataConfig(**fields))
    assert isinstance(got, tds.FederatedDataset)
    assert_datasets_equal(got, want)
    assert got.fallback == want.fallback
    if fields["dataset"] == "digits" and fields["scenario"] == "robot_drift":
        assert got.windows == 3


# --------------------------------------- the sybil fleet through both engines

def test_sybil_fleet_through_both_engines(capsys):
    """64 clients with a 16-sybil replica clique, ``small_model(32)``, 3
    rounds of fedar + foolsgold_sketch with full participation and the
    deviation ban off, through the live reference engine and the port
    (the reference's init params and draws replayed): trust and masks
    identical, params, the defense history and the defense's weights
    within 2e-4 of the reference's."""
    import jax.numpy as jnp
    import torch

    from _torch_parity import JEngine, JReq, assert_bookkeeping_equal, reference_draws
    from repro_torch.configs.fedar_mnist import fleet_fed, small_model
    from repro_torch.convert import ReplayDraws, params_from_jax
    from repro_torch.core.fedar import FedARServer
    from repro_torch.core.resources import TaskRequirement

    N, sybils, rounds = 64, 16, 3
    fed_kw = dict(local_epochs=2, defense="foolsgold_sketch", num_poisoners=sybils,
                  num_starved=0, client_fraction=1.0, deviation_gamma=1e9)
    jdata, jmask = jfed.sybil_fleet(N, sybils, samples_per_client=40)
    data, mask = tfed.sybil_fleet(N, sybils, samples_per_client=40)
    assert_tree_equal((data, mask), (jdata, jmask))
    ev = tsrc.get_source("synthetic").sample(100, seed=99)
    jeng = JEngine(jcfg.small_model(32), jcfg.fleet_fed(N, **fed_kw), JReq())
    jstate, jouts = jeng.run(jeng.init_state(),
                             {k: jnp.asarray(v) for k, v in jdata.items()},
                             rounds=rounds, eval_set=(jnp.asarray(ev[0]), jnp.asarray(ev[1])))
    server = FedARServer(small_model(32), fleet_fed(N, **fed_kw), TaskRequirement(),
                         device="cpu", draws=ReplayDraws(**reference_draws(0, rounds, N)),
                         init_params=params_from_jax(jeng.template)[0])
    hist = server.run(data, rounds=rounds, eval_set=ev)
    assert_bookkeeping_equal(jstate, jouts, server, hist)
    np.testing.assert_allclose(server.state.params.numpy(), np.asarray(jstate.params),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(server.fg_history.numpy(), np.asarray(jstate.fg_history),
                               rtol=2e-4, atol=2e-4)
    got = server.engine.defense.weights(server.fg_history, torch.ones(N, dtype=torch.bool))
    want = np.asarray(jeng.defense.weights(jstate.fg_history, jnp.ones(N, bool)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # the clique is down-weighted and every honest client keeps its weight
    assert got[mask].max() < 0.1 and got[~mask].min() > 0.5
    with capsys.disabled():
        print(f"\n  sybil fleet after {rounds} rounds: defense weights sybil max "
              f"{got[mask].max():.4f} (reference {want[mask].max():.4f}), honest min "
              f"{got[~mask].min():.4f} (reference {want[~mask].min():.4f})")
