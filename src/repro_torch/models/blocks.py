"""Per-layer blocks of the LM trunk: the attention block (GQA with a dense
gated FFN, the ``attn`` kind and zamba's shared block) and the Mamba2
block.  A block is (init, forward, cache init, decode) over a params dict;
decode updates the block's cache in place and returns it.

MoE, MLA and xLSTM blocks are ROADMAP Queue 1 item 14.3b and raise.
"""
from __future__ import annotations

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.ffn import ffn_forward, init_ffn
from repro_torch.models.layers import rms_norm


def check_attn_block(cfg: ModelConfig) -> None:
    """Raise for the attention-block variants not ported yet."""
    if cfg.attention == "mla":
        raise NotImplementedError("MLA blocks are not ported yet (ROADMAP Queue 1 item 14.3b)")
    if cfg.num_experts:
        raise NotImplementedError("MoE blocks are not ported yet (ROADMAP Queue 1 item 14.3b)")


def init_attn_block(generator, cfg: ModelConfig, dtype, device):
    """Norm scales in fp32 (zeros: the norm multiplies by ``1 + scale``),
    GQA and FFN weights in ``dtype``."""
    check_attn_block(cfg)
    zeros = dict(dtype=torch.float32, device=device)
    return {
        "ln1": torch.zeros(cfg.d_model, **zeros),
        "ln2": torch.zeros(cfg.d_model, **zeros),
        "attn": attn.init_gqa(generator, cfg, dtype, device),
        "ffn": init_ffn(generator, cfg.d_model, cfg.d_ff, dtype, device),
    }


def attn_block_forward(p, x, positions, cfg: ModelConfig, window, impl="auto"):
    """Pre-norm GQA then pre-norm FFN, each added to the residual."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.gqa_forward(p["attn"], h, positions, cfg, window, impl)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn_forward(p["ffn"], h, cfg.act)


def init_attn_block_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device):
    check_attn_block(cfg)
    return attn.init_kv_cache(cfg, batch, cache_len, dtype, device)


def attn_block_decode(p, cache, x_t, pos: int, cfg: ModelConfig, window):
    h = rms_norm(x_t, p["ln1"], cfg.norm_eps)
    a, cache = attn.gqa_decode(p["attn"], cache, h, pos, cfg, window)
    x = x_t + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn_forward(p["ffn"], h, cfg.act), cache


def init_mamba_block(generator, cfg: ModelConfig, dtype, device):
    return {
        "ln": torch.zeros(cfg.d_model, dtype=torch.float32, device=device),
        "mamba": ssm_mod.init_mamba2(generator, cfg, dtype, device),
    }


def mamba_block_forward(p, x, cfg: ModelConfig, impl="auto"):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + ssm_mod.mamba2_forward(p["mamba"], h, cfg, impl)


def init_mamba_block_cache(cfg: ModelConfig, batch: int, dtype, device):
    return ssm_mod.init_mamba2_cache(cfg, batch, dtype, device)


def mamba_block_decode(p, cache, x_t, cfg: ModelConfig):
    h = rms_norm(x_t, p["ln"], cfg.norm_eps)
    y, cache = ssm_mod.mamba2_decode(p["mamba"], cache, h, cfg)
    return x_t + y, cache


def init_xlstm_pair(*_args, **_kw):
    raise NotImplementedError("xLSTM blocks are not ported yet (ROADMAP Queue 1 item 14.3b)")


def xlstm_pair_forward(*_args, **_kw):
    raise NotImplementedError("xLSTM blocks are not ported yet (ROADMAP Queue 1 item 14.3b)")


def xlstm_pair_decode(*_args, **_kw):
    raise NotImplementedError("xLSTM decode is not ported yet (ROADMAP Queue 1 item 14.3b)")
