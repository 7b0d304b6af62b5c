"""The port's public API against the reference's: the facade's names
(``repro/__init__.py``) and ``FedARServer.run``'s ``driver`` argument
(``repro/core/fedar.py``), on the CPU."""
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro_torch import (
    ClientModel,
    FedAREngine,
    FedARServer,
    FedConfig,
    LMClientModel,
    MnistClientModel,
    MnistConfig,
    TaskRequirement,
    fleet_fed,
    make_federated,
    small_model,
)
from repro_torch.configs import get_config


def test_facade_exports_the_reference_names():
    assert set(repro.__all__) <= set(repro_torch.__all__)
    assert set(repro_torch.__all__) - set(repro.__all__) == {
        "MnistConfig", "fleet_fed", "small_model"}
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name) is not None
    # the facade re-exports the deep modules' objects
    from repro_torch.common.config import FedConfig as deep_cfg
    from repro_torch.core.engine import FedAREngine as deep_engine
    from repro_torch.data.datasets import make_federated as deep_make
    from repro_torch.models.model import LMClientModel as deep_lm

    assert (FedConfig, FedAREngine, make_federated, LMClientModel) == (
        deep_cfg, deep_engine, deep_make, deep_lm)
    assert isinstance(MnistClientModel(MnistConfig()), ClientModel)
    assert issubclass(LMClientModel, ClientModel)


def _server(**over):
    fed = fleet_fed(12, defense="foolsgold_sketch", **over)
    return FedARServer(small_model(16), fed, TaskRequirement(), device="cpu")


def test_run_takes_both_reference_drivers():
    """The port has one host loop over rounds: ``driver="scan"`` (the
    default) and ``"python"`` run it alike, round for round."""
    ds = make_federated("table2", 12, samples_per_client=40)
    ev = (ds.x[0, :30], ds.y[0, :30])
    hists = {}
    for driver in ("scan", "python"):
        server = _server()
        hists[driver] = server.run(ds, rounds=2, eval_set=ev, driver=driver)
        hists[driver]["params"] = server.state.params
    a, b = hists["scan"], hists["python"]
    for key in ("trust", "selected", "on_time"):
        np.testing.assert_array_equal(np.stack(a[key]), np.stack(b[key]))
    assert a["loss"] == b["loss"] and a["acc"] == b["acc"]
    assert torch.equal(a["params"], b["params"])
    server = _server()
    assert server.run(ds, rounds=1) is server.history


@pytest.mark.parametrize("driver", ["jit", "", None])
def test_run_refuses_another_driver(driver):
    with pytest.raises(ValueError, match="unknown driver"):
        _server().run(make_federated("table2", 12, samples_per_client=10), rounds=1,
                      driver=driver)


def test_cohort_mode_takes_both_drivers():
    fleet = make_federated("table2", 12, samples_per_client=10)
    for driver in ("scan", "python"):
        server = _server(cohort_size=6)
        server.run(fleet, rounds=1, driver=driver)
        assert len(server.history["cohort"]) == 1


def test_lm_client_runs_through_the_facade():
    cfg = get_config("tinyllama-1.1b").reduced(num_layers=1, d_model=32, d_ff=64,
                                               vocab_size=64, num_heads=2,
                                               num_kv_heads=1)
    fed = fleet_fed(4, defense="foolsgold_sketch", local_epochs=1, local_batch_size=2)
    server = FedARServer(LMClientModel(cfg, device="cpu"), fed, TaskRequirement(),
                         lr=0.05, device="cpu")
    from repro_torch.data.pipeline import federated_lm_corpus

    data, meta = federated_lm_corpus(4, vocab=64, seq=8, samples_per_client=4,
                                     topics=2)
    hist = server.run(data, rounds=2, eval_set=meta["eval"], driver="python")
    assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()
    assert server.engine.sgd_route == "einsum"
    leaves = server.params["layers"][0]["attn"]["wq"]
    assert leaves.shape == (32, 2, 16)
    with pytest.raises(ValueError, match="has none"):
        FedARServer(LMClientModel(cfg, device="cpu"),
                    fleet_fed(4, defense="none", sgd_impl="kernel"), TaskRequirement(),
                    device="cpu")
