"""The port's checkpoints: exact round trips and a bit-exact store resume.

An ``EngineState`` (async + QSGD, so every leaf is non-empty) and a tree
with a bf16 leaf come back exactly; a cohort run (chaos, async, 4-bit
QSGD, ``foolsgold_sketch``) saved mid-run with ``save_store`` and resumed
in a fresh ``CohortEngine`` ends bit-equal to the uninterrupted run in
every store column, params and trust; a missing leaf and a shape mismatch
are refused.  The package reads and writes its own format, so it needs no
``msgpack``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import restore, restore_store, save, save_store
from repro_torch.configs.fedar_mnist import fleet_fed, small_model
from repro_torch.core.client_store import ClientStore
from repro_torch.core.engine import CohortEngine, FedAREngine
from repro_torch.core.resources import TaskRequirement
from repro_torch.data.datasets import VirtualFleet
from repro_torch.data.federated import table2_fleet

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
REQ = TaskRequirement()


def _assert_trees_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    else:
        assert a == b


def test_engine_state_round_trips_exactly(tmp_path):
    fed = fleet_fed(12, aggregation="async", compress="qsgd", compress_bits=4,
                    defense="foolsgold_sketch", faults="chaos")
    eng = FedAREngine(small_model(8), fed, REQ, device="cpu")
    state, _ = eng.run(eng.init_state(), table2_fleet(samples_per_client=20), rounds=2)
    assert state.compress_residual.abs().sum() > 0
    path = str(tmp_path / "state.pt")
    save(path, state, step=2)
    back, step = restore(path, eng.init_state())
    assert step == 2 and back.round_idx == 2
    _assert_trees_equal(back, state)
    assert not os.path.exists(path + ".tmp")
    tree = {"w": torch.randn(3, 4).to(torch.bfloat16), "n": np.arange(5, dtype=np.int32),
            "layers": [torch.ones(2), torch.zeros(2, dtype=torch.bool)]}
    save(path, tree)
    back, _ = restore(path, {"w": torch.zeros(3, 4), "n": np.zeros(5, np.int32),
                             "layers": [torch.zeros(2), torch.zeros(2, dtype=torch.bool)]})
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], tree["w"])
    np.testing.assert_array_equal(back["n"], tree["n"])
    assert torch.equal(back["layers"][1], tree["layers"][1])


def _cohort_engine():
    fed = fleet_fed(40, cohort_size=8, aggregation="async", compress="qsgd",
                    compress_bits=4, defense="foolsgold_sketch", faults="chaos")
    return CohortEngine(small_model(8), fed, REQ, device="cpu")


def test_store_resume_is_bit_equal_to_the_uninterrupted_run(tmp_path):
    fleet = VirtualFleet(40, samples_per_client=20, device="cpu")
    whole = _cohort_engine()
    whole.run(fleet, rounds=5)
    first = _cohort_engine()
    first.run(fleet, rounds=2)
    path = str(tmp_path / "store.pt")
    save_store(path, first.store, params=first.params, step=2)
    resumed = _cohort_engine()
    params, step = restore_store(path, resumed.store, with_params=True)
    assert step == 2 and resumed.round_idx == 2
    resumed.params = params
    resumed.run(fleet, rounds=3)
    assert whole.store.pending_issued.max() > 0 and whole.store.residual.any()
    for name, want in whole.store.state_dict().items():
        np.testing.assert_array_equal(resumed.store.state_dict()[name], want,
                                      err_msg=name)
    assert torch.equal(resumed.params, whole.params)
    no_params, _ = restore_store(path, _cohort_engine().store)
    assert no_params is None


def test_restore_rejects_a_missing_leaf(tmp_path):
    path = str(tmp_path / "a.pt")
    save(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="no record for 'b'"):
        restore(path, {"a": torch.zeros(3), "b": torch.zeros(2)})
    store = _cohort_engine().store
    save_store(path, store)
    with pytest.raises(ValueError, match="no bundled params"):
        restore_store(path, store, with_params=True)
    save(path, {"store": {k: v for k, v in store.state_dict().items()
                          if k != "pending_delta"}})
    with pytest.raises(ValueError, match="pending_delta"):
        restore_store(path, store)


def test_restore_rejects_a_shape_mismatch(tmp_path):
    path = str(tmp_path / "a.pt")
    save(path, {"a": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="shape mismatch for a"):
        restore(path, {"a": torch.zeros(2, 3)})
    save_store(path, ClientStore(fleet_fed(30), 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_store(path, ClientStore(fleet_fed(40), 4))


def test_checkpoint_imports_no_msgpack():
    code = ("import sys, repro_torch.checkpoint.ckpt\n"
            "assert 'msgpack' not in sys.modules\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
