"""Per-layer blocks of the LM trunk: the attention block (GQA or MLA,
followed by a dense gated FFN or a mixture of experts, which in Arctic runs
beside a dense residual FFN; the ``attn`` kind and zamba's shared block),
the Mamba2 block and the xLSTM pair (an sLSTM then an mLSTM sub-layer).  A
block is (init, forward, cache init, decode) over a params dict; decode
updates the block's cache in place and returns it.
"""
from __future__ import annotations

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.ffn import ffn_forward, init_ffn
from repro_torch.models.layers import rms_norm
from repro_torch.models.moe import init_moe, moe_forward


def init_attn_block(generator, cfg: ModelConfig, dtype, device):
    """Norm scales in fp32 (zeros: the norm multiplies by ``1 + scale``),
    MLA or GQA, then the MoE (with Arctic's dense residual FFN) or the
    dense FFN; weights in ``dtype`` but the MoE's fp32 router and shared
    gate."""
    zeros = dict(dtype=torch.float32, device=device)
    p = {"ln1": torch.zeros(cfg.d_model, **zeros), "ln2": torch.zeros(cfg.d_model, **zeros)}
    if cfg.attention == "mla":
        p["attn"] = attn.init_mla(generator, cfg, dtype, device)
    else:
        p["attn"] = attn.init_gqa(generator, cfg, dtype, device)
    if cfg.num_experts:
        p["moe"] = init_moe(generator, cfg, dtype, device)
        if cfg.dense_residual:
            p["ffn"] = init_ffn(generator, cfg.d_model, cfg.d_ff, dtype, device)
    else:
        p["ffn"] = init_ffn(generator, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def ffn_sublayer(p, h, cfg: ModelConfig):
    """The block's second sub-layer on the normed residual h: (its output,
    the MoE's aux loss, None without one)."""
    if not cfg.num_experts:
        return ffn_forward(p["ffn"], h, cfg.act), None
    mo, aux = moe_forward(p["moe"], h, cfg)
    if cfg.dense_residual:
        mo = mo + ffn_forward(p["ffn"], h, cfg.act)
    return mo, aux


def attn_block_forward(p, x, positions, cfg: ModelConfig, window, impl="auto"):
    """Pre-norm attention then the pre-norm FFN or MoE, each added to the
    residual.  Returns (x, the MoE's aux loss or None)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attention == "mla":
        x = x + attn.mla_forward(p["attn"], h, positions, cfg, window, impl)
    else:
        x = x + attn.gqa_forward(p["attn"], h, positions, cfg, window, impl)
    mo, aux = ffn_sublayer(p, rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + mo, aux


def init_attn_block_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device):
    if cfg.attention == "mla":
        return attn.init_mla_cache(cfg, batch, cache_len, dtype, device)
    return attn.init_kv_cache(cfg, batch, cache_len, dtype, device)


def attn_block_decode(p, cache, x_t, pos: int, cfg: ModelConfig, window):
    """One token through the block; the MoE's aux loss is dropped, as in
    the reference."""
    h = rms_norm(x_t, p["ln1"], cfg.norm_eps)
    if cfg.attention == "mla":
        a, cache = attn.mla_decode(p["attn"], cache, h, pos, cfg, window)
    else:
        a, cache = attn.gqa_decode(p["attn"], cache, h, pos, cfg, window)
    x = x_t + a
    mo, _ = ffn_sublayer(p, rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + mo, cache


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


def init_xlstm_pair(generator, cfg: ModelConfig, dtype, device):
    """The two sub-layers with their fp32 norm scales."""
    zeros = dict(dtype=torch.float32, device=device)
    return {
        "ln_s": torch.zeros(cfg.d_model, **zeros),
        "slstm": xlstm_mod.init_slstm(generator, cfg, dtype, device),
        "ln_m": torch.zeros(cfg.d_model, **zeros),
        "mlstm": xlstm_mod.init_mlstm(generator, cfg, dtype, device),
    }


def xlstm_pair_forward(p, x, cfg: ModelConfig):
    """Pre-norm sLSTM then pre-norm mLSTM, each added to the residual."""
    h = rms_norm(x, p["ln_s"], cfg.norm_eps)
    x = x + xlstm_mod.slstm_forward(p["slstm"], h, cfg)
    h = rms_norm(x, p["ln_m"], cfg.norm_eps)
    return x + xlstm_mod.mlstm_forward(p["mlstm"], h, cfg)


def init_xlstm_pair_cache(cfg: ModelConfig, batch: int, device):
    return {
        "slstm": xlstm_mod.init_slstm_cache(cfg, batch, device),
        "mlstm": xlstm_mod.init_mlstm_cache(cfg, batch, device),
    }


def xlstm_pair_decode(p, cache, x_t, cfg: ModelConfig):
    h = rms_norm(x_t, p["ln_s"], cfg.norm_eps)
    y, _ = xlstm_mod.slstm_decode(p["slstm"], cache["slstm"], h, cfg)
    x = x_t + y
    h = rms_norm(x, p["ln_m"], cfg.norm_eps)
    y, _ = xlstm_mod.mlstm_decode(p["mlstm"], cache["mlstm"], h, cfg)
    return x + y, cache
