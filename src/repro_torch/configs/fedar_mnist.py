"""The paper's own simulation setting (§IV): 12 mobile robots, 28x28 digit
classification, MLP trained with local SGD (B=20, E=5 default), plus a
fleet-size-parameterized variant for engine-scale runs and the dataset /
scenario knobs of the federated data layer (``data/datasets.py``)."""
from dataclasses import dataclass, replace
from typing import Optional

from repro_torch.common.config import FedConfig


@dataclass(frozen=True)
class MnistConfig:
    name: str = "fedar-mnist"
    input_dim: int = 784  # flattened 28x28 (paper §IV.B)
    hidden: int = 128
    num_classes: int = 10


@dataclass(frozen=True)
class DataConfig:
    """Federated dataset / scenario knobs, resolved by ``make_data``.

    ``dataset``: a builder of the ``data/datasets.py`` registry, a legacy
    fleet (``table2`` / ``scaled`` / ``sybil``) or a pool dataset
    (``digits`` / ``mnist`` / ``emnist``; real IDX files from ``cache_dir``
    or the deterministic offline fallback).  ``scenario`` / ``alpha`` /
    ``drift_windows`` apply to pool datasets only: ``iid``, ``label_skew``
    (Dirichlet alpha), ``quantity_skew`` (Dirichlet-size alpha) or
    ``robot_drift`` (class mixtures rotating across ``drift_windows``
    activity windows)."""

    dataset: str = "scaled"
    scenario: str = "label_skew"
    samples_per_client: int = 200
    alpha: float = 0.5
    drift_windows: int = 4
    # the sample source of the legacy fleet builders (table2 / scaled /
    # sybil): synthetic keeps the seed-exact pool, mnist / emnist use the
    # cache-or-fallback sources
    source: str = "synthetic"
    cache_dir: Optional[str] = None
    seed: int = 0


CONFIG = MnistConfig()
FED = FedConfig()
DATA = DataConfig()


def make_data(num_clients: int, dcfg: DataConfig = DATA):
    """The fleet ``dcfg`` describes, built through the dataset registry: a
    ``data.datasets.FederatedDataset`` for ``FedAREngine.prepare_data``
    (mask / round_mask ride along for ragged or drifting scenarios)."""
    from repro_torch.data.datasets import make_federated

    kw = dict(seed=dcfg.seed, samples_per_client=dcfg.samples_per_client,
              cache_dir=dcfg.cache_dir)
    if dcfg.dataset in ("digits", "mnist", "emnist"):
        kw["scenario"] = dcfg.scenario
        if dcfg.scenario in ("label_skew", "quantity_skew", "robot_drift"):
            kw["alpha"] = dcfg.alpha
        if dcfg.scenario == "robot_drift":
            kw["windows"] = dcfg.drift_windows
    else:
        kw["source"] = dcfg.source
    return make_federated(dcfg.dataset, num_clients, **kw)


def fleet_fed(num_clients: int = 12, **overrides) -> FedConfig:
    """A ``FedConfig`` scaled to an arbitrary fleet size; pass any
    ``FedConfig`` field as an override."""
    return replace(FED, num_clients=num_clients, **overrides)


def small_model(hidden: int = 32) -> MnistConfig:
    """A reduced client model for large-fleet benchmarks and smoke tests."""
    return replace(CONFIG, hidden=hidden)
