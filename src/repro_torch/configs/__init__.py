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

import importlib

from repro_torch.common.config import ModelConfig

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
