"""Attention for the LM trunk: GQA with full or sliding-window causal masks,
and multi-head latent attention (MLA, MiniCPM3 / DeepSeek-V2), for prefill
and for single-token decode over a cache.

The route is the model's ``attn_impl`` (``kernels/ops.resolve_impl``): on
the card ``gqa_forward`` calls kernel 8 (``ops.flash_attention``) with the
layer's window, reading GQA's kv heads without repeating them; on the CPU,
or with ``attn_impl="einsum"``, it takes ``_attend_chunked``, the
reference model's q-chunked blockwise attention.  The two compute the same
function (``tests/test_torch_lm_kernels.py``).

MLA's prefill (``mla_forward``) is the reference's expanded form: q and k
of ``qk_nope_dim + qk_rope_dim`` columns a head, v of ``v_head_dim``.  Its
kernel route zero-pads v to q's head dim, calls kernel 8 there and slices
the output back: a zero column of v gives an exactly zero output column,
and the kernel's scale is q's head dim, as the plain route's.

Decode (``gqa_decode``, ``mla_decode``) is plain PyTorch on every device,
as in the reference: one query against the whole cache, which is full
length (``cache_len`` = the longest sequence) or, for a window, a ring
buffer of ``cache_len`` = window slots.  MLA's cache holds the latent
``ckv`` and the shared rotary key ``krope`` of each position, and its
decode attends in the latent space (the absorbed form).  Decode reaches no
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init

Q_CHUNK = 1024  # q-block size for blockwise attention


def init_gqa(generator, cfg: ModelConfig, dtype, device):
    hd = cfg.resolved_head_dim
    return {
        "wq": dense_init(generator, (cfg.d_model, cfg.num_heads, hd), 0, dtype, device),
        "wk": dense_init(generator, (cfg.d_model, cfg.num_kv_heads, hd), 0, dtype, device),
        "wv": dense_init(generator, (cfg.d_model, cfg.num_kv_heads, hd), 0, dtype, device),
        "wo": dense_init(generator, (cfg.num_heads, hd, cfg.d_model), (0, 1), dtype,
                         device),
    }


def _repeat_kv(k, num_heads):
    """(B, S, K, hd) -> (B, S, H, hd) by repeating each kv head H / K times."""
    K = k.shape[2]
    if K == num_heads:
        return k
    return k.repeat_interleave(num_heads // K, dim=2)


def _attend_chunked(q, k, v, q_positions, k_positions, window: int):
    """Blockwise causal attention, the plain route.

    q: (B, Sq, H, hd); k, v: (B, Sk, H, hd); q_positions (Sq,), k_positions
    (Sk,) absolute positions; window 0 = full causal, else the sliding
    window.  Scores are taken in q's dtype and softmaxed in fp32, as in the
    reference.  Past ``Q_CHUNK`` query rows, q-chunk i attends only to the
    causal key prefix ``k[:(i + 1) * Q_CHUNK]`` (self-attention: both
    position ranges are the same).  Returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    scale = hd ** -0.5
    w_eff = window if window > 0 else 1 << 30

    def mask_for(qp, kp):
        return (kp[None, :] <= qp[:, None]) & (kp[None, :] > qp[:, None] - w_eff)

    def attend(qc, kc, vc, qp, kp):
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kc).to(torch.float32) * scale
        s = torch.where(mask_for(qp, kp)[None, None], s, -1e30)
        p = torch.softmax(s, dim=-1).to(vc.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, vc)

    if Sq <= Q_CHUNK:
        return attend(q, k, v, q_positions, k_positions)
    if Sq % Q_CHUNK:
        # the reference's loop drops the remainder rows; the kernel route
        # takes any S
        raise ValueError(f"the plain attention route takes S <= {Q_CHUNK} or a "
                         f"multiple of it, got {Sq}")
    outs = []
    for i in range(Sq // Q_CHUNK):
        rows = slice(i * Q_CHUNK, (i + 1) * Q_CHUNK)
        kend = (i + 1) * Q_CHUNK
        outs.append(attend(q[:, rows], k[:, :kend], v[:, :kend], q_positions[rows],
                           k_positions[:kend]))
    return torch.cat(outs, dim=1)


def gqa_forward(params, x, positions, cfg: ModelConfig, window: int = 0,
                impl: str = "auto"):
    """Training / prefill path. x: (B, S, d); positions: (S,), the
    self-attention positions 0..S-1."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    q = apply_rope(q, positions[None, :], cfg.rope_theta)
    k = apply_rope(k, positions[None, :], cfg.rope_theta)
    if ops.resolve_impl(impl, "attn", x.device) == "kernel":
        o = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=True, window=int(window), impl="kernel")
    else:
        k = _repeat_kv(k, cfg.num_heads)
        v = _repeat_kv(v, cfg.num_heads)
        o = _attend_chunked(q, k, v, positions, positions, int(window))
    return torch.einsum("bshk,hkd->bsd", o, params["wo"])


def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device):
    hd = cfg.resolved_head_dim
    shape = (batch, cache_len, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _ring_valid(cache_len: int, pos: int, window: int, device):
    """Which of ``cache_len`` ring slots hold a position in ``(pos -
    window, pos]``: slot i holds ``pos - ((pos - i) mod cache_len)``."""
    idx = torch.arange(cache_len, device=device)
    slot_pos = pos - torch.remainder(pos - idx, cache_len)  # floor-mod
    w_eff = window if window > 0 else 1 << 30
    return (slot_pos >= 0) & (slot_pos <= pos) & (slot_pos > pos - w_eff)


def gqa_decode(params, cache, x_t, pos: int, cfg: ModelConfig, window: int = 0):
    """Single-token decode.  x_t: (B, 1, d); pos: the new token's index.

    Writes the token's k and v into slot ``pos % cache_len`` of ``cache``
    in place, then attends over all ``cache_len`` slots, masking those that
    hold no position in ``(pos - window, pos]`` (a ring slot holds position
    ``pos - ((pos - slot) mod cache_len)``).  Scores and softmax in fp32, p
    cast back to the cache's dtype, as in the reference.  Returns (out (B,
    1, d), cache)."""
    cache_len = cache["k"].shape[1]
    q = torch.einsum("bsd,dhk->bshk", x_t, params["wq"])
    k_t = torch.einsum("bsd,dhk->bshk", x_t, params["wk"])
    v_t = torch.einsum("bsd,dhk->bshk", x_t, params["wv"])
    posv = torch.full((1, 1), pos, device=x_t.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k_t = apply_rope(k_t, posv, cfg.rope_theta)

    slot = pos % cache_len  # == pos whenever cache_len covers the sequence
    cache["k"][:, slot] = k_t[:, 0]
    cache["v"][:, slot] = v_t[:, 0]
    valid = _ring_valid(cache_len, pos, window, x_t.device)

    kk = _repeat_kv(cache["k"], cfg.num_heads)
    vv = _repeat_kv(cache["v"], cfg.num_heads)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk).to(torch.float32) * q.shape[-1] ** -0.5
    s = torch.where(valid[None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1).to(vv.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    return torch.einsum("bshk,hkd->bsd", o, params["wo"]), cache


def init_mla(generator, cfg: ModelConfig, dtype, device):
    H = cfg.num_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    r = cfg.kv_lora_rank

    def w(shape, in_axis=0):
        return dense_init(generator, shape, in_axis, dtype, device)

    return {
        # q: d -> q_lora -> per-head (nope + rope)
        "wq_a": w((cfg.d_model, cfg.q_lora_rank)),
        "wq_b": w((cfg.q_lora_rank, H, qk)),
        # kv: d -> the latent, and the rotary key shared by the heads
        "wkv_a": w((cfg.d_model, r)),
        "wk_rope": w((cfg.d_model, cfg.qk_rope_dim)),
        # latent -> per-head k_nope and v
        "wk_b": w((r, H, cfg.qk_nope_dim)),
        "wv_b": w((r, H, cfg.v_head_dim)),
        "wo": w((H, cfg.v_head_dim, cfg.d_model), (0, 1)),
    }


def mla_forward(params, x, positions, cfg: ModelConfig, window: int = 0,
                impl: str = "auto"):
    """Expanded-form MLA for training / prefill.  x: (B, S, d); positions:
    (S,).  The kernel route hands kernel 8 v zero-padded to q's head dim
    (64 -> 96 at minicpm3-4b) and keeps the first ``v_head_dim`` columns of
    its output."""
    q = torch.einsum("bsr,rhk->bshk", torch.matmul(x, params["wq_a"]), params["wq_b"])
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions[None, :], cfg.rope_theta)

    c_kv = torch.matmul(x, params["wkv_a"])
    k_rope = torch.matmul(x, params["wk_rope"])  # shared by the heads
    k_rope = apply_rope(k_rope[:, :, None, :], positions[None, :], cfg.rope_theta)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["wk_b"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, params["wv_b"])

    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1], cfg.qk_rope_dim)], dim=-1)
    if ops.resolve_impl(impl, "attn", x.device) == "kernel":
        dqk, dv = q_full.shape[-1], v.shape[-1]
        if dv > dqk:
            raise ValueError(f"v_head_dim {dv} is wider than q's head dim {dqk}: kernel 8 "
                             "takes one head dim, and padding q would change its scale")
        v_pad = torch.nn.functional.pad(v, (0, dqk - dv))
        o = ops.flash_attention(q_full.contiguous(), k_full.contiguous(),
                                v_pad.contiguous(), causal=True, window=int(window),
                                impl="kernel")[..., :dv]
    else:
        o = _attend_chunked(q_full, k_full, v, positions, positions, int(window))
    return torch.einsum("bshk,hkd->bsd", o, params["wo"])


def init_mla_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device):
    return {
        "ckv": torch.zeros((batch, cache_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "krope": torch.zeros((batch, cache_len, cfg.qk_rope_dim), dtype=dtype,
                             device=device),
    }


def mla_decode(params, cache, x_t, pos: int, cfg: ModelConfig, window: int = 0):
    """Absorbed-form MLA decode: the query is taken into the latent space,
    so the cache holds only ``kv_lora_rank + qk_rope_dim`` values a
    position.  Writes slot ``pos % cache_len`` in place and masks the ring
    as ``gqa_decode`` does.  Returns (out (B, 1, d), cache)."""
    cache_len = cache["ckv"].shape[1]
    posv = torch.full((1, 1), pos, device=x_t.device)
    q = torch.einsum("bsr,rhk->bshk", torch.matmul(x_t, params["wq_a"]), params["wq_b"])
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, posv, cfg.rope_theta)

    c_t = torch.matmul(x_t, params["wkv_a"])  # (B, 1, r)
    kr_t = torch.matmul(x_t, params["wk_rope"])
    kr_t = apply_rope(kr_t[:, :, None, :], posv, cfg.rope_theta)[:, :, 0, :]
    slot = pos % cache_len
    cache["ckv"][:, slot] = c_t[:, 0]
    cache["krope"][:, slot] = kr_t[:, 0]
    ckv, krope = cache["ckv"], cache["krope"]
    valid = _ring_valid(cache_len, pos, window, x_t.device)

    # absorb: q_nope (B, 1, H, n) . wk_b (r, H, n) -> the latent query (B, H, r)
    q_abs = torch.einsum("bshk,rhk->bhr", q_nope, params["wk_b"])
    s_lat = torch.einsum("bhr,btr->bht", q_abs, ckv)
    s_rope = torch.einsum("bshk,btk->bht", q_rope, krope)
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    s = (s_lat + s_rope).to(torch.float32) * scale
    s = torch.where(valid[None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1).to(ckv.dtype)
    o_lat = torch.einsum("bht,btr->bhr", p, ckv)
    o = torch.einsum("bhr,rhk->bhk", o_lat, params["wv_b"])
    return torch.einsum("bhk,hkd->bd", o, params["wo"])[:, None, :], cache
