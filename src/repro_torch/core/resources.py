"""Resource model for the simulated robot fleet (CheckResource, §III.B.2).

Each client n exposes (memory M_n, bandwidth B_n, battery E_n, compute F_n).
Virtual time replaces the paper's physical robots:

  latency_n = train_flops / F_n + model_bytes / B_n   (compute + upload)

Battery drains with participation; a drained client fails ``CheckResource``.
Heterogeneity mirrors §IV.A: reliable robots, resource-starved ones and
unreliable/poisoning ones.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ResourceState(NamedTuple):
    memory: torch.Tensor  # (N,) MB available
    bandwidth: torch.Tensor  # (N,) MB/s
    battery: torch.Tensor  # (N,) in [0, 1]
    compute: torch.Tensor  # (N,) MFLOP/s


class TaskRequirement(NamedTuple):
    memory: float = 64.0  # MB
    bandwidth: float = 0.5  # MB/s
    battery: float = 0.15


STARVED_FRAC = 1.0 / 6.0  # paper §IV.A: 2 of 12 robots are resource-starved
POISON_FRAC = 1.0 / 6.0  # ... and 2 of 12 are unreliable/poisoning
# battery cost of one training round; idle clients recharge at 1/4 of it
BATTERY_COST = 0.02
# sigma of the log-normal latency jitter (the reference's round_latency default)
LATENCY_JITTER = 0.15


def make_fleet(
    num_clients: int,
    *,
    num_starved: int | None = None,
    num_poisoners: int | None = None,
    starved_frac: float = STARVED_FRAC,
    poison_frac: float = POISON_FRAC,
    seed: int = 0,
    device="cpu",
) -> tuple[ResourceState, np.ndarray]:
    """Heterogeneous fleet per §IV.A, at any fleet size.  Returns
    (resources, poisoner mask).  The last ``num_poisoners`` clients send
    corrupted models; the ``num_starved`` before them have scarce
    memory/battery/bandwidth.  Drawn with numpy, then cast to float32, so
    the values are bit-identical to the reference's."""
    if num_starved is None:
        num_starved = int(round(num_clients * starved_frac))
    if num_poisoners is None:
        num_poisoners = int(round(num_clients * poison_frac))
    if num_starved + num_poisoners > num_clients:
        raise ValueError("starved + poisoners exceed fleet size")
    rng = np.random.default_rng(seed)
    memory = rng.uniform(128, 1024, num_clients)
    bandwidth = rng.uniform(1.0, 8.0, num_clients)
    battery = rng.uniform(0.6, 1.0, num_clients)
    compute = rng.uniform(50, 400, num_clients)  # MFLOP/s

    starved = slice(num_clients - num_poisoners - num_starved,
                    num_clients - num_poisoners)
    memory[starved] = rng.uniform(16, 72, num_starved)
    bandwidth[starved] = rng.uniform(0.05, 0.4, num_starved)
    battery[starved] = rng.uniform(0.1, 0.3, num_starved)
    compute[starved] = rng.uniform(5, 30, num_starved)

    poison = np.zeros(num_clients, bool)
    if num_poisoners:
        poison[-num_poisoners:] = True

    def col(v):
        return torch.as_tensor(v.astype(np.float32), device=device)

    res = ResourceState(memory=col(memory), bandwidth=col(bandwidth),
                        battery=col(battery), compute=col(compute))
    return res, poison


def check_resource(res: ResourceState, req: TaskRequirement) -> torch.Tensor:
    """Algorithm 1 CheckResource: the RA list as a boolean mask over
    clients.  An exactly-dead client (battery == 0) is always rejected."""
    return (
        (res.memory >= req.memory)
        & (res.bandwidth >= req.bandwidth)
        & (res.battery >= req.battery)
        & (res.battery > 0.0)
    )


def resource_score(res: ResourceState, req: TaskRequirement) -> torch.Tensor:
    """Secondary sort key (Algorithm 2 line 8): normalized headroom over the
    requirement, float32."""
    return (
        torch.clamp(res.memory / req.memory, max=4.0)
        + torch.clamp(res.bandwidth / req.bandwidth, max=4.0)
        + torch.clamp(res.battery / max(req.battery, 1e-6), max=4.0)
    ) / 3.0


def round_latency(
    res: ResourceState,
    *,
    train_flops: float,
    model_bytes: float,
    factor: torch.Tensor,
) -> torch.Tensor:
    """Virtual seconds for one local round per client (compute + upload)
    times ``factor``, this round's (N,) log-normal jitter
    ``exp(LATENCY_JITTER * z)`` from the engine's draw provider
    (``latency_factor``).  The scalars divide as float32 tensors: a Python
    number over a tensor is a reciprocal and a product in PyTorch, two
    roundings where the reference has one."""
    flops = torch.tensor(train_flops, dtype=torch.float32)
    nbytes = torch.tensor(model_bytes, dtype=torch.float32)
    base = flops / (res.compute * 1e6) + nbytes / (res.bandwidth * 1e6)
    return base * factor


def drain_battery(
    res: ResourceState, participated: torch.Tensor, *, cost: float = BATTERY_COST
) -> ResourceState:
    """Battery cost of one training round; idle clients trickle-charge."""
    batt = torch.where(
        participated,
        torch.clamp(res.battery - cost, min=0.0),
        torch.clamp(res.battery + cost / 4, max=1.0),
    )
    return res._replace(battery=batt)
