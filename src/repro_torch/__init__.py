"""PyTorch + CUDA port of the FedAR reproduction (the JAX package ``repro``
is the reference it is held against).

One import surface, the reference's eight names plus the MLP's config
helpers:

    from repro_torch import FedConfig, FedARServer, LMClientModel, make_federated

The entry points (``FedAREngine``, ``FedARServer``, the LM's
``models.model.Model`` and ``LMClientModel``) run on the card (``cuda``)
and raise without one; pass ``device="cpu"`` to run on the CPU.  The
kernels of the round (local SGD, aggregation, the defense similarity block,
the count sketch, and the uplink codecs: 4-bit code packing, its inverse
and the top-k decode) and of the LM's prefill (flash attention, the Mamba2
SSD scan) are CUDA C++ under ``csrc/``, built with ``nvcc`` at first use
(``kernels/ops.py``).  ``python -m repro_torch.launch.train`` trains an LM
config with the optimizers of ``optim/``; ``python -m
repro_torch.launch.dryrun`` checks every config and input shape on the
production meshes on PyTorch's ``meta`` device.
"""
from repro_torch.common.config import FedConfig
from repro_torch.configs.fedar_mnist import MnistConfig, fleet_fed, small_model
from repro_torch.core.engine import FedAREngine
from repro_torch.core.fedar import FedARServer
from repro_torch.core.resources import TaskRequirement
from repro_torch.data.datasets import make_federated
from repro_torch.models.client import ClientModel
from repro_torch.models.mnist import MnistClientModel
from repro_torch.models.model import LMClientModel

__all__ = [
    "ClientModel",
    "FedAREngine",
    "FedARServer",
    "FedConfig",
    "LMClientModel",
    "MnistClientModel",
    "MnistConfig",
    "TaskRequirement",
    "fleet_fed",
    "make_federated",
    "small_model",
]
