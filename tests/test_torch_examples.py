"""The port's copies of the two FedAR examples, run on the CPU through
``main([..., "--device", "cpu"])`` at a few rounds and ~30 samples a
client: the quickstart (Table II, a quantity-skewed EMNIST pool on the
packed layout with selection gating, the host-store cohort engine with
async + QSGD + chaos faults, the auto-cohort past 4,096 clients) and the
poisoning demo (paper scale and the engine-scale sybil clique); then the
two and the federated LM example over four gloo ranks (``--device cpu
--devices 4``) against their one-process runs."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _idx_files import write_cache
from _torch_mesh_jobs import one_thread

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart_torch", "poisoning_defense_torch")


def load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quickstart(*argv):
    return load("quickstart_torch").main([*argv, "--device", "cpu"])


def test_quickstart_paper_fleet(capsys):
    hist = quickstart("--rounds", "2", "--samples", "30")
    out = capsys.readouterr().out
    assert "dataset=table2" in out and "layout=dense: pad-to-max 30" in out
    assert len(hist["acc"]) == 2 and np.isfinite(hist["loss"]).all()
    assert hist["trust"][-1].shape == (12,)


@pytest.mark.parametrize("cached", [False, True], ids=["fallback", "cached"])
def test_quickstart_emnist_quantity_skew_gated(tmp_path, capsys, cached):
    if cached:
        write_cache(tmp_path, n=600, names=("emnist",))
    hist = quickstart("--clients", "16", "--dataset", "emnist", "--scenario",
                      "quantity_skew", "--select_frac", "0.5", "--rounds", "2",
                      "--samples", "30", "--cache_dir", str(tmp_path))
    out = capsys.readouterr().out
    assert "dataset=emnist scenario=quantity_skew" in out
    assert ("offline synthetic fallback" in out) != cached
    assert "layout=packed" in out and "batch tiles against" in out
    assert "WARNING" not in out
    assert len(hist["acc"]) == 2 and np.isfinite(hist["acc"]).all()


def test_quickstart_warns_on_mixed_splits(tmp_path, capsys):
    write_cache(tmp_path, n=300, names=("mnist",), splits=("train",))
    quickstart("--clients", "12", "--dataset", "mnist", "--scenario", "iid",
               "--rounds", "1", "--samples", "20", "--cache_dir", str(tmp_path),
               "--no-packed")
    out = capsys.readouterr().out
    assert "WARNING: mnist train and test splits disagree (train real IDX, test fallback)" in out
    assert "layout=dense" in out


def test_quickstart_cohort_async_qsgd_chaos(capsys):
    hist = quickstart("--clients", "24", "--cohort", "8", "--aggregation", "async",
                      "--compress", "qsgd", "--faults", "chaos", "--rounds", "2",
                      "--samples", "20")
    out = capsys.readouterr().out
    assert "dataset=virtual" in out and "cohort K=8" in out
    assert "[uplink] compress=qsgd" in out and "quarantine armed" in out
    assert "final trust scores (store head, 24 of 24)" in out
    assert len(hist["cohort"]) == 2 and hist["trust"][-1].shape == (8,)


def test_quickstart_auto_cohort_and_topk(capsys):
    quickstart("--clients", "4097", "--rounds", "1", "--samples", "10")
    out = capsys.readouterr().out
    assert "auto-enabling the host-store cohort engine (K=512" in out
    quickstart("--clients", "24", "--compress", "topk", "--aggregation", "fedavg",
               "--rounds", "1", "--samples", "20")
    assert "[uplink] compress=topk" in capsys.readouterr().out


def test_quickstart_rejects_bad_flags():
    with pytest.raises(SystemExit):
        quickstart("--scenario", "iid")  # table2 has no scenario axis
    with pytest.raises(SystemExit):
        quickstart("--clients", "24", "--cohort", "8", "--select_frac", "0.5")


@pytest.mark.parametrize("clients", [12, 64])
def test_poisoning_demo(capsys, clients):
    s1, s0, fgw, sybils = load("poisoning_defense_torch").main(
        ["--clients", str(clients), "--rounds", "2", "--samples", "30",
         "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(s1.history["acc"]) == len(s0.history["acc"]) == 2
    assert s1.fed.defense != "none" and s0.fed.defense == "none"
    assert sybils.sum() == (2 if clients == 12 else 16)
    assert "final: defended" in out
    if clients == 12:
        assert fgw is None and "deviation ban" in out
    else:
        assert fgw.shape == (64,) and "defense weights: sybil max" in out
        assert fgw[sybils].max() < fgw[~sybils].min()
    with pytest.raises(SystemExit):
        load("poisoning_defense_torch").main(["--clients", "32", "--device", "cpu"])


@pytest.mark.parametrize("name", EXAMPLES)
def test_devices_past_one_raise(name, monkeypatch):
    """``--devices 2`` on the cards (the default device) needs CUDA devices:
    with none it raises before any rank starts."""
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        load(name).main(["--devices", "2"])


def _importable(name, monkeypatch):
    """The example imported by name, so that the mesh's spawned ranks can
    import the function they run."""
    import importlib

    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    return importlib.import_module(name)


def test_quickstart_on_a_cpu_mesh(monkeypatch, capfd):
    """``--device cpu --devices 4``: four gloo ranks; rank 0 prints the mesh
    line, and its history matches the one-process run's (trust and masks
    identical, accuracy within 1e-3).  A 30-client fleet is padded to 32."""
    mod = _importable("quickstart_torch", monkeypatch)
    argv = ["--dataset", "digits", "--scenario", "quantity_skew", "--rounds", "2",
            "--samples", "30", "--device", "cpu"]
    mesh = mod.main(argv + ["--clients", "32", "--devices", "4"])
    out = capfd.readouterr().out
    assert "mesh: 4 client shards x 8 clients" in out and "layout=packed" in out
    with one_thread():
        one = mod.main(argv + ["--clients", "32"])
    for key in ("trust", "selected", "on_time"):
        np.testing.assert_array_equal(np.stack(mesh[key]), np.stack(one[key]))
    np.testing.assert_allclose(mesh["acc"], one["acc"], atol=1e-3)
    mod.main(argv + ["--clients", "30", "--devices", "4"])
    assert "fleet padded 30 -> 32 clients to divide by 4 shards" in capfd.readouterr().out


def test_poisoning_demo_on_a_cpu_mesh(monkeypatch, capfd):
    """The engine-scale demo over four gloo ranks: the clique's defense
    weights as in the one-process run (1e-4)."""
    mod = _importable("poisoning_defense_torch", monkeypatch)
    argv = ["--clients", "64", "--rounds", "2", "--samples", "30", "--device", "cpu"]
    h1, h0, fgw, sybils = mod.main(argv + ["--devices", "4"])
    assert "mesh: 4 client shards x 16 clients" in capfd.readouterr().out
    with one_thread():
        s1, _, fgw1, _ = mod.main(argv)
    np.testing.assert_allclose(fgw, fgw1, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(np.stack(h1["selected"]), np.stack(s1.history["selected"]))
    assert fgw[sybils].max() < fgw[~sybils].min()
    with pytest.raises(SystemExit):
        mod.main(["--clients", "66", "--devices", "4", "--device", "cpu"])


def test_examples_leave_out_jax_and_reference():
    """Both examples, imported and run for one round in a fresh process,
    load neither JAX nor the reference package."""
    code = (
        "import importlib.util, sys\n"
        "for name, argv in (('quickstart_torch', ['--clients', '16', '--dataset', 'digits',\n"
        "                    '--scenario', 'quantity_skew']),\n"
        "                   ('poisoning_defense_torch', ['--clients', '64'])):\n"
        f"    spec = importlib.util.spec_from_file_location(name, '{ROOT}/examples/' + name + '.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    mod.main(argv + ['--rounds', '1', '--samples', '20', '--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.data.sources' in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_federated_lm_on_a_cpu_mesh(monkeypatch, capfd):
    """``examples/federated_lm_torch.py --device cpu --devices 4``: four gloo
    ranks, one client each; the history matches the one-process run's
    (trust and masks identical, held-out loss within 1e-4)."""
    mod = _importable("federated_lm_torch", monkeypatch)
    argv = ["--clients", "4", "--rounds", "2", "--samples", "8", "--device", "cpu"]
    mesh = mod.main(argv + ["--devices", "4"])["fedar"]
    assert "mesh: 4 client shards x 1 clients" in capfd.readouterr().out
    with one_thread():
        one = mod.main(argv)["fedar"]
    for key in ("trust", "selected", "on_time"):
        np.testing.assert_array_equal(np.stack(mesh[key]), np.stack(one[key]))
    np.testing.assert_allclose(mesh["loss"], one["loss"], atol=1e-4, rtol=1e-4)
