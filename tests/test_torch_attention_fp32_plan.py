"""Kernel 8's fp32 plan and its key split, on the CPU.

``fp32_plan`` is pure Python: it is held here at the attention shape of
every config of the repo (full width and ``reduced()``, each layer
window, at 1 x 1,024 and 4 x 2,048 tokens): its shared bytes fit a block,
its parts cover each query tile's live key tiles once, and it splits where
the grid would leave SMs idle.  The split's arithmetic (partials in base 2,
the merge in part order) is ``ref.flash_attention_partials_ref`` and
``ref.flash_attention_merge_ref``, held against ``ref.flash_attention_ref``
and against the reference package's Pallas kernel in interpret mode, as
its own tests run it.  The CUDA kernels are held against the plain version
on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_kernel
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (FP32_INSTANCES, FP32_MAX_PARTS, fp32_key_tiles,
                                                 fp32_part_tiles, fp32_plan)
from repro_torch.models.model import layer_windows, model_kind

# the partials summed in another order than the full softmax: fp32 rounding
FP32_TOL = 1e-5
SMS = 132  # an H100's SMs


def attention_shapes(cfg):
    """(H, K, hd, windows) of the config's attention layers; MLA hands the
    kernel q and k at nope + rope columns and one kv head a query head."""
    if cfg.attention == "mla":
        return cfg.num_heads, cfg.num_heads, cfg.qk_nope_dim + cfg.qk_rope_dim, \
            sorted(set(layer_windows(cfg).tolist()))
    return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, \
        sorted(set(layer_windows(cfg).tolist()))


CONFIG_SHAPES = [
    pytest.param(arch, width, B, S, id=f"{arch}-{width}-{B}x{S}")
    for arch in ARCH_IDS if model_kind(get_config(arch)) != "xlstm"
    for width in ("full", "reduced")
    for B, S in ((1, 1024), (4, 2048))
]


def live_keys(S, row, *, causal, window):
    lo = max(0, row - window + 1) if window else 0
    return lo, (row + 1 if causal else S)


@pytest.mark.parametrize("arch,width,B,S", CONFIG_SHAPES)
def test_fp32_plan_at_every_config_attention_shape(arch, width, B, S):
    cfg = get_config(arch)
    if width == "reduced":
        cfg = cfg.reduced()
    H, K, hd, windows = attention_shapes(cfg)
    for window in windows:
        p = fp32_plan(B, S, H, K, hd, window, sms=SMS)
        assert p.smem_bytes <= ops.MAX_SMEM_BYTES
        assert p.instance >= hd and (p.instance == 64 or p.instance // 2 < hd)
        assert (p.block_q, p.block_k) == FP32_INSTANCES[p.instance][:2]
        assert p.pitch % 4 == 0 and (p.pitch // 4) % 2 == 1 and p.pitch >= hd
        assert p.copy_bytes == (16 if hd % 4 == 0 else 4)
        nq = -(-S // p.block_q)
        assert p.blocks == B * H * nq * p.parts
        assert p.workspace == (p.blocks * p.block_q * (hd + 2) if p.parts > 1 else 0)
        assert 1 <= p.parts <= FP32_MAX_PARTS
        assert (p.parts > 1) == (B * H * nq < SMS)
        for qt in range(nq):
            first, end = fp32_key_tiles(S, p.block_q, p.block_k, qt, causal=True, window=window)
            # the tiles hold every live key of every row of the query tile
            rows = range(qt * p.block_q, min(S, (qt + 1) * p.block_q))
            assert first * p.block_k <= min(live_keys(S, r, causal=True,
                                                         window=window)[0] for r in rows)
            assert end * p.block_k >= max(r + 1 for r in rows)
            assert (end - 1) * p.block_k < min(S, (qt + 1) * p.block_q)
            # the parts cover [first, end) once, in order, without a gap
            cover = [fp32_part_tiles(first, end, part, p.parts) for part in range(p.parts)]
            assert cover[0][0] == first and cover[-1][1] == end
            assert all(a[1] == b[0] for a, b in zip(cover, cover[1:]))
            assert all(lo <= hi for lo, hi in cover)


@pytest.mark.parametrize("window", [0, 512])
def test_fp32_plan_fills_the_card_at_gemma3_route_check(window):
    """gemma3-1b's route check (1 x 1,024, 4 heads of 256 over one kv
    head): 64 query-tile blocks alone would leave 68 SMs idle; the split
    gives at least two blocks an SM, and no part longer than a third of
    the longest tile."""
    p = fp32_plan(1, 1024, 4, 1, 256, window, sms=SMS)
    assert B_H_NQ(p) == 64
    assert p.blocks >= 2 * SMS and p.parts > 1
    first, end = fp32_key_tiles(1024, p.block_q, p.block_k, 15, causal=True, window=window)
    longest = max(hi - lo for lo, hi in (fp32_part_tiles(first, end, q, p.parts)
                                         for q in range(p.parts)))
    assert longest <= -(-(end - first) // 3)
    # zamba2-7b's prefill and its route check fill the card without a split
    assert fp32_plan(4, 2048, 32, 32, 112, sms=SMS).parts == 1
    assert fp32_plan(1, 1024, 32, 32, 112, sms=SMS).parts == 1


def B_H_NQ(p):
    return p.blocks // p.parts


def test_fp32_plan_refuses_what_no_plan_takes():
    for args in ((1, 64, 4, 4, 0), (1, 64, 4, 4, 257), (1, 64, 4, 3, 64), (1, 0, 4, 4, 64)):
        with pytest.raises(ValueError):
            fp32_plan(*args)
    with pytest.raises(ValueError, match="parts"):
        fp32_plan(1, 64, 4, 4, 64, parts=FP32_MAX_PARTS + 1)
    with pytest.raises(ValueError, match="grid"):
        fp32_plan(1, 256 * 70_000, 1, 1, 64)


def split_ranges(S, hd, window, parts, causal=True):
    """The plan's key ranges (in keys) for every query tile and part."""
    p = fp32_plan(1, S, 1, 1, hd, window, causal=causal, parts=parts, sms=SMS)
    nq = -(-S // p.block_q)
    ranges = []
    for qt in range(nq):
        first, end = fp32_key_tiles(S, p.block_q, p.block_k, qt, causal=causal, window=window)
        ranges.append([tuple(p.block_k * t for t in fp32_part_tiles(first, end, q, parts))
                       for q in range(parts)])
    return p, ranges


def qkv(B, S, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, n, hd)).astype(np.float32) for n in (H, K, K))


@pytest.mark.parametrize("S,H,K,hd,window,parts", [
    (320, 4, 2, 32, 0, 3),     # the 64 instance (256-row query tiles), GQA
    (320, 4, 4, 40, 64, 3),    # a window of one key tile: some rows have no key in a part
    (320, 2, 1, 24, 100, 16),  # more parts than key tiles: empty parts
    (320, 4, 2, 96, 0, 2),     # the 128 instance (128-key tiles), a part-filled last tile
    (192, 2, 2, 136, 0, 2),    # the 256 instance (64-row query tiles)
])
def test_split_partials_and_merge_match_reference(S, H, K, hd, window, parts):
    """Partials over the plan's parts, merged in part order, against the
    port's plain version and the reference's Pallas kernel (interpret
    mode, 32 x 32 blocks, kv heads repeated as its callers do); no NaN
    where a part holds no live key of a row."""
    q, k, v = qkv(1, S, H, K, hd, seed=S + hd + parts)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    p, ranges = split_ranges(S, hd, window, parts)
    part_o, part_ml = ref.flash_attention_partials_ref(tq, tk, tv, ranges,
                                                       block_q=p.block_q, window=window)
    got = ref.flash_attention_merge_ref(part_o, part_ml, S)
    assert torch.isfinite(got).all()
    want = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FP32_TOL, atol=FP32_TOL)
    G = H // K
    kern = jax_flash_kernel(jnp.asarray(q), jnp.asarray(np.repeat(k, G, axis=2)),
                            jnp.asarray(np.repeat(v, G, axis=2)), causal=True, window=window,
                            interpret=True, block_q=32, block_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=FP32_TOL, atol=FP32_TOL)
    if window == 64:
        # a live part that holds no key of some of its tile's rows
        m = part_ml[..., 0]
        live_part = torch.tensor([[hi > lo for lo, hi in r] for r in ranges])
        assert bool(((m == -torch.inf).any(dim=-1) & live_part).any())


def test_split_merge_without_causal_mask_matches_plain():
    q, k, v = (torch.as_tensor(a) for a in qkv(2, 200, 4, 1, 48, seed=9))
    p, ranges = split_ranges(200, 48, 48, 2, causal=False)
    part_o, part_ml = ref.flash_attention_partials_ref(q, k, v, ranges, block_q=p.block_q,
                                                       causal=False, window=48)
    got = ref.flash_attention_merge_ref(part_o, part_ml, 200)
    want = ref.flash_attention_ref(q, k, v, causal=False, window=48)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FP32_TOL, atol=FP32_TOL)
