"""The paper's own simulation setting (§IV): 12 mobile robots, 28x28 digit
classification, MLP trained with local SGD (B=20, E=5 default), plus a
fleet-size-parameterized variant for engine-scale runs."""
from dataclasses import dataclass, replace

from repro_torch.common.config import FedConfig


@dataclass(frozen=True)
class MnistConfig:
    name: str = "fedar-mnist"
    input_dim: int = 784  # flattened 28x28 (paper §IV.B)
    hidden: int = 128
    num_classes: int = 10


CONFIG = MnistConfig()
FED = FedConfig()


def fleet_fed(num_clients: int = 12, **overrides) -> FedConfig:
    """A ``FedConfig`` scaled to an arbitrary fleet size; pass any
    ``FedConfig`` field as an override."""
    return replace(FED, num_clients=num_clients, **overrides)


def small_model(hidden: int = 32) -> MnistConfig:
    """A reduced client model for large-fleet benchmarks and smoke tests."""
    return replace(CONFIG, hidden=hidden)
