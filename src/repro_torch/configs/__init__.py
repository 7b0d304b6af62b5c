"""Architecture config registry.

The port carries the configurations whose trunk it runs, each with the
shapes and citation of the reference's file: ``zamba2-7b`` (Mamba2 blocks
plus one weight-shared attention block), the dense GQA configs
``tinyllama-1.1b``, ``yi-9b`` and ``gemma3-1b`` (local/global windows, tied
embeddings, tanh GELU, head_dim 256), the mixtures of experts
``qwen2-moe-a2.7b`` (shared experts) and ``arctic-480b`` (a dense residual
FFN), ``minicpm3-4b`` (multi-head latent attention), and the FedAR client
model ``fedar-mnist``.  The reference's other architectures raise
``NotImplementedError``: their blocks (xLSTM, the stubbed frontends) are
ROADMAP Queue 1 item 14.3b.
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
PORTED = ("zamba2-7b", "tinyllama-1.1b", "yi-9b", "gemma3-1b", "qwen2-moe-a2.7b",
          "arctic-480b", "minicpm3-4b")

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch == "fedar-mnist":
        return importlib.import_module("repro_torch.configs.fedar_mnist").CONFIG
    if arch not in _MOD:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS + ['fedar-mnist']}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported yet (ROADMAP Queue 1 item 14.3b); the port "
            f"runs {list(PORTED)}"
        )
    return importlib.import_module(f"repro_torch.configs.{_MOD[arch]}").CONFIG
