"""Shared neural-net layers: RMSNorm, rotary embeddings, initializers.

Initializers draw from an explicit ``torch.Generator`` on the generator's
own device (on an H100 a CUDA generator fills zamba2-7b's 6.75 B params
in under a second, ``chip_smoke.py`` phase 9) and place the result on
``device``.  The values differ from the
reference's ``jax.random`` draws, so parity tests load the reference's
params through ``convert.lm_params_from_jax``.  On the ``meta`` device
they draw nothing and give the shapes alone (``launch/input_specs.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _normal(generator: torch.Generator, shape, std: float, dtype, device):
    if torch.device(device).type == "meta":  # shapes only, nothing to draw
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (t * std).to(device=device, dtype=dtype)


def dense_init(generator, shape, in_axis, dtype, device):
    """Variance-scaling (fan-in) init used for all projection matrices:
    normal with std 1 / sqrt(prod of the ``in_axis`` dims)."""
    axes = in_axis if isinstance(in_axis, tuple) else (in_axis,)
    fan_in = math.prod(shape[a] for a in axes)
    return _normal(generator, shape, 1.0 / math.sqrt(fan_in), dtype, device)


def embed_init(generator, shape, dtype, device):
    return _normal(generator, shape, 0.02, dtype, device)


def rms_norm(x, scale, eps=1e-6):
    """RMSNorm in fp32, scaled by ``1 + scale``, cast back to x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(dt)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Split-half
    rotation (the first and second halves of head_dim are the pairs), in
    fp32, cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(name: str):
    """``gelu`` is the tanh approximation, as ``jax.nn.gelu``'s default."""
    return {
        "silu": F.silu,
        "gelu": lambda t: F.gelu(t, approximate="tanh"),
        "relu": F.relu,
    }[name]
