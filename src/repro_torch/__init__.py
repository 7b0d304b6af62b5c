"""PyTorch + CUDA port of the FedAR reproduction (the JAX package ``repro``
is the reference it is held against).

The entry points (``FedAREngine``, ``FedARServer``, and the LM's
``models.model.Model``) run on the card (``cuda``) and raise without one;
pass ``device="cpu"`` to run on the CPU.  The kernels of the round (local
SGD, aggregation, the defense similarity block, and the uplink codecs:
4-bit code packing, its inverse and the top-k decode) and of the LM's
prefill (flash attention, the Mamba2 SSD scan) are CUDA C++ under
``csrc/``, built with ``nvcc`` at first use (``kernels/ops.py``).
"""
from repro_torch.configs.fedar_mnist import MnistConfig, fleet_fed, small_model
from repro_torch.core.engine import FedAREngine
from repro_torch.core.fedar import FedARServer
from repro_torch.core.resources import TaskRequirement

__all__ = [
    "FedAREngine",
    "FedARServer",
    "MnistConfig",
    "TaskRequirement",
    "fleet_fed",
    "small_model",
]
