"""Gated-MLP (SwiGLU / GeGLU) feed-forward."""
from __future__ import annotations

import torch

from repro_torch.models.layers import activation, dense_init


def init_ffn(generator, d_model: int, d_ff: int, dtype, device):
    return {
        "w_gate": dense_init(generator, (d_model, d_ff), 0, dtype, device),
        "w_up": dense_init(generator, (d_model, d_ff), 0, dtype, device),
        "w_down": dense_init(generator, (d_ff, d_model), 0, dtype, device),
    }


def ffn_forward(params, x, act: str = "silu"):
    """``act(x . w_gate) * (x . w_up) . w_down``."""
    g = activation(act)(torch.matmul(x, params["w_gate"]))
    u = torch.matmul(x, params["w_up"])
    return torch.matmul(g * u, params["w_down"])
