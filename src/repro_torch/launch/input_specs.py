"""Shape-only stand-ins for every (arch x input-shape) workload.

The reference builds ``jax.ShapeDtypeStruct``s; the port builds tensors on
PyTorch's ``meta`` device, which carry a shape and a dtype and no data, so
nothing is allocated.  ``Model`` and ``init_cache`` run on ``meta`` as they
are (``kernels/ops.resolve_impl`` sends ``meta`` tensors to the plain
routes), and the dry run (``dryrun.py``) traces its steps on them.
"""
from __future__ import annotations

import torch

from repro_torch.common.config import InputShape, ModelConfig
from repro_torch.models.model import VISION_STUB_DIM, Model

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _text_inputs(cfg: ModelConfig, shape: InputShape) -> tuple[dict, int]:
    B, S = shape.global_batch, shape.seq_len
    batch = {}
    text = S
    if cfg.frontend == "vision_stub":
        text = S - cfg.num_patches
        batch["patches"] = sds((B, cfg.num_patches, VISION_STUB_DIM), torch.float32)
    batch["tokens"] = sds((B, text), torch.int32)
    return batch, text


def train_inputs(cfg: ModelConfig, shape: InputShape) -> dict:
    batch, text = _text_inputs(cfg, shape)
    batch["labels"] = sds((shape.global_batch, text), torch.int32)
    return batch


def prefill_inputs(cfg: ModelConfig, shape: InputShape) -> dict:
    return _text_inputs(cfg, shape)[0]


def decode_inputs(cfg: ModelConfig, shape: InputShape) -> dict:
    """tokens: one new token; cache: the port's ``init_cache`` tree on
    ``meta``; pos: the step's position, the last of the context (the
    reference's is an abstract scalar; the port's ``decode_step`` takes a
    Python int)."""
    B, S = shape.global_batch, shape.seq_len
    return {
        "tokens": sds((B, 1), torch.int32),
        "cache": Model(cfg, META).init_cache(B, S),
        "pos": S - 1,
    }


def abstract_params(cfg: ModelConfig):
    return Model(cfg, META).init_params(torch.Generator())


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    if shape.kind == "train":
        return train_inputs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_inputs(cfg, shape)
    return decode_inputs(cfg, shape)
