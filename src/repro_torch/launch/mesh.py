"""Production and host meshes, and the card's roofline constants.

The reference lays its production runs on TPU v5e pods: a (data, model)
mesh of 16 x 16 chips, or (pod, data, model) over two pods.  The port keeps
that logical layout as a plain object (axis names and a shape) for the
sharding policy (``sharding.py``) and the dry run (``dryrun.py``); no card
runs it, and there is no SPMD partitioner behind it.  ``make_host_mesh``
lays a (data, model) mesh over the CUDA devices this process sees, clamped
to their count as the reference clamps to ``jax.devices()``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.engine import resolve_device


@dataclass(frozen=True)
class Mesh:
    """A logical device mesh: ``shape[i]`` devices along ``axis_names[i]``,
    and the torch devices behind it where it is a host mesh (empty for the
    production layout, which no card runs)."""

    shape: tuple
    axis_names: tuple
    devices: tuple = ()

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        """Devices along axis ``name``; 1 for an axis the mesh lacks."""
        return dict(zip(self.axis_names, self.shape)).get(name, 1)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """Small mesh over the devices actually present (tests / examples): the
    CUDA devices (``device`` None means the card, raising without one), or
    the one CPU when ``device="cpu"``."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    data = min(data, n)
    model = max(1, min(model, n // data))
    devices = (tuple(torch.device("cuda", i) for i in range(data * model))
               if dev.type == "cuda" else (dev,))
    return Mesh((data, model), ("data", "model"), devices)


# Hardware constants for the roofline model: one NVIDIA H100 SXM 80 GB at
# its 700 W power limit (NVIDIA's data sheet; a card set below 700 W runs
# slower under load): dense bf16 tensor-core peak, HBM3 bandwidth, and
# NVLink 4 (900 GB/s to the host's other cards, all to all) each way.
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
HBM_BW = 3.35e12  # B/s
NVLINK_BW = 450e9  # B/s a direction
