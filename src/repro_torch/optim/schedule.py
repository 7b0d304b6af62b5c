"""LR schedules: constant, linear warmup + cosine decay."""
from __future__ import annotations

import math

import torch

from repro_torch.common.config import TrainConfig


def make_schedule(tc: TrainConfig):
    """``sched(step) -> lr``: ``tc.lr`` itself for a constant schedule
    without warmup, else a 0-d float32 tensor on the CPU, computed in fp32
    as the reference computes it (a 0-d CPU tensor enters a CUDA op as a
    scalar, with no copy to the card)."""
    if tc.schedule == "const" and not tc.warmup_steps:
        return lambda step: tc.lr

    def sched(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
        if tc.schedule == "cosine":
            frac = torch.clamp(
                (step - tc.warmup_steps) / max(tc.total_steps - tc.warmup_steps, 1),
                0.0, 1.0,
            )
            decay = 0.5 * (1 + torch.cos(math.pi * frac))
        else:
            decay = 1.0
        return tc.lr * warm * decay

    return sched
