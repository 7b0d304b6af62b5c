"""Architecture config registry.

The port carries all ten of the reference's architectures, each with the
shapes and citation of the reference's file: ``zamba2-7b`` (Mamba2 blocks
plus one weight-shared attention block), the dense GQA configs
``tinyllama-1.1b``, ``yi-9b`` and ``gemma3-1b`` (local/global windows, tied
embeddings, tanh GELU, head_dim 256), the mixtures of experts
``qwen2-moe-a2.7b`` (shared experts) and ``arctic-480b`` (a dense residual
FFN), ``minicpm3-4b`` (multi-head latent attention), ``xlstm-350m`` (sLSTM
and mLSTM pairs), ``internvl2-1b`` (stubbed vision patches ahead of the
text) and ``musicgen-medium`` (codec tokens, the audio stub), and the FedAR
client model ``fedar-mnist``.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.common.config import InputShape, ModelConfig

ARCH_IDS = [
    "zamba2-7b",
    "internvl2-1b",
    "arctic-480b",
    "qwen2-moe-a2.7b",
    "xlstm-350m",
    "minicpm3-4b",
    "musicgen-medium",
    "tinyllama-1.1b",
    "yi-9b",
    "gemma3-1b",
]
PORTED = tuple(ARCH_IDS)

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch == "fedar-mnist":
        return importlib.import_module("repro_torch.configs.fedar_mnist").CONFIG
    if arch not in _MOD:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS + ['fedar-mnist']}")
    return importlib.import_module(f"repro_torch.configs.{_MOD[arch]}").CONFIG


LONG_WINDOW = 4096  # window cap applied to attention layers at 500k context


def cfg_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-conditioned config tweaks.

    long_500k requires sub-quadratic attention: SSM archs run natively; every
    attention layer gets a sliding window (ring-buffer KV cache) capped at
    LONG_WINDOW.
    """
    if shape.name == "long_500k" and cfg.attention != "none":
        over = {}
        if cfg.sliding_window == 0 or cfg.sliding_window > LONG_WINDOW:
            over["sliding_window"] = LONG_WINDOW
        if cfg.global_every and (
            cfg.local_window == 0 or cfg.local_window > LONG_WINDOW
        ):
            over["local_window"] = min(cfg.local_window or LONG_WINDOW, LONG_WINDOW)
        if over:
            cfg = dataclasses.replace(cfg, **over)
    return cfg
