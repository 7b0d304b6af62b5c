"""Kernel 9 (the SSD scan) on the CPU: the float64 yardstick, the bf16
instance's rounding plan, and its launch plan.

The bf16 CUDA instance (``csrc/ssm_scan.cu``) runs on the card only
(``tests/test_torch_cuda.py``).  Its arithmetic is emulated here in plain
PyTorch at its rounding points: per chunk of 64 positions, the decayed
C B^T rounded to bf16; B_j exp(lc_L - lc_j) and the carried fp32 state each
split into a hi + lo pair of bf16 values; exp(lc_i) applied to the fp32
result of C . state.  The emulation is held row by row (a row is one head
of one position) to ``BF16_RTOL`` of its row's largest value against the
sequential recurrence, as ``chip_smoke.py`` holds the kernel; rounding the
state, or B_j exp(lc_L - lc_j), to one bf16 instead misses by more.  Inputs
are numpy arrays made from a seed.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.ssm_scan import CHUNK, SMEM_BYTES, plan, ssm_scan

# an output ulp of bf16 against each row's largest value (chip_smoke.py)
BF16_RTOL = 1.6e-2
# Hopper: shared memory an SM holds, and what the runtime reserves a block
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def ssm_inputs(B=2, S=64, nh=16, hd=32, st=16, seed=0):
    rng = np.random.default_rng(seed)
    xd = (rng.standard_normal((B, S, nh, hd)) * 0.5).astype(np.float32)
    logdecay = -np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    Bc = (rng.standard_normal((B, S, st)) * 0.5).astype(np.float32)
    Cc = (rng.standard_normal((B, S, st)) * 0.5).astype(np.float32)
    return xd, logdecay, Bc, Cc


@functools.lru_cache(maxsize=None)
def model_case(seed, B=1, S=2048, nh=32, hd=64, st=64):
    """zamba2-7b's decay range as the model makes it (dt = softplus(.),
    A = -linspace(1, 16, nh), x scaled by dt), inputs rounded to bf16 as
    the kernel reads them; with the sequential recurrence on them."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh))))
    logdecay = torch.as_tensor((dt * -np.linspace(1.0, 16.0, nh)).astype(np.float32))
    xd = _bf16(torch.as_tensor((rng.standard_normal((B, S, nh, hd)) * dt[..., None])
                               .astype(np.float32)))
    Bc, Cc = (_bf16(torch.as_tensor(rng.standard_normal((B, S, st)).astype(np.float32)))
              for _ in "BC")
    return (xd, logdecay, Bc, Cc), ref.ssm_scan_ref(xd, logdecay, Bc, Cc)


def _parts(t, split: bool):
    hi = _bf16(t)
    return [hi, _bf16(t - hi)] if split else [hi]


def emulate_bf16_kernel(xd, logdecay, Bc, Cc, *, split_state=True, split_decayed_b=True):
    """The bf16 instance's chunked SSD at its rounding points (fp32
    between them).  ``split_state`` / ``split_decayed_b`` False round that
    operand to one bf16 value instead of a hi + lo pair."""
    B, S, nh, hd = xd.shape
    st = Bc.shape[-1]
    state = torch.zeros(B, nh, st, hd)
    ys = []
    for t0 in range(0, S, CHUNK):
        x, lc = xd[:, t0:t0 + CHUNK], torch.cumsum(logdecay[:, t0:t0 + CHUNK], dim=1)
        b, c = Bc[:, t0:t0 + CHUNK], Cc[:, t0:t0 + CHUNK]
        n = x.shape[1]
        tri = torch.tril(torch.ones(n, n, dtype=torch.bool))[None, :, :, None]
        gap = torch.where(tri, lc[:, :, None, :] - lc[:, None, :, :], 0.0)
        g = _bf16(torch.where(tri, torch.einsum("bis,bjs->bij", c, b)[..., None]
                              * torch.exp(gap), 0.0))
        inter = sum(torch.einsum("bis,bnsh->binh", c, p)
                    for p in _parts(state, split_state))
        ys.append(torch.einsum("bijn,bjnh->binh", g, x) + inter * torch.exp(lc)[..., None])
        bw = b[:, :, None, :] * torch.exp(lc[:, -1:] - lc)[..., None]  # (B, L, nh, st)
        state = state * torch.exp(lc[:, -1])[:, :, None, None] + sum(
            torch.einsum("bjns,bjnh->bnsh", p, x) for p in _parts(bw, split_decayed_b))
    return torch.cat(ys, dim=1)


def largest_ratio(got, want):
    """Largest |error| / (BF16_RTOL * max|want| of its row), both sides
    rounded to bf16 as the kernel's output and its check are."""
    got, want = _bf16(got), _bf16(want)
    limit = BF16_RTOL * want.abs().amax(dim=-1, keepdim=True)
    return ((got - want).abs() / limit.clamp_min(1e-30)).max().item()


# ---------------------------------------------------------------------------
# the float64 yardstick
# ---------------------------------------------------------------------------

def test_float64_recurrence_agrees_with_fp32_and_the_reference():
    arrays = ssm_inputs()
    t = [torch.as_tensor(a) for a in arrays]
    y64 = ref.ssm_scan_ref(*t, dtype=torch.float64)
    assert y64.dtype == torch.float64 and y64.shape == t[0].shape
    assert ref.ssm_scan_ref(*t).dtype == torch.float32
    # fp32 rounding over 64 steps
    np.testing.assert_allclose(ref.ssm_scan_ref(*t).numpy(), y64.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y64.numpy(), jref.ssm_scan_ref(*map(jnp.asarray, arrays)),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the bf16 instance's rounding plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 28])
def test_rounding_plan_holds_row_by_row(seed):
    """S = 2,048 (32 chunks), 32 heads over the model's decay range."""
    inputs, want = model_case(seed)
    assert largest_ratio(emulate_bf16_kernel(*inputs), want) <= 1.0


@pytest.mark.parametrize("operand", ["state", "decayed_b"])
def test_one_bf16_value_for_a_state_operand_misses(operand):
    """What the plan's hi + lo pairs buy: on the same inputs, rounding the
    carried state (or B_j exp(lc_L - lc_j), which builds it) to one bf16
    value puts some row more than an output ulp off (seed 28: of seeds
    0-29 the one where both do; the state alone misses at most seeds)."""
    inputs, want = model_case(28)
    got = emulate_bf16_kernel(*inputs, **{f"split_{operand}": False})
    assert largest_ratio(got, want) > 1.0


def test_rounding_plan_holds_on_a_ragged_last_chunk():
    """S = 130: two whole chunks and one of 2 positions."""
    xd, logdecay, Bc, Cc = (torch.as_tensor(a) for a in ssm_inputs(S=130, seed=5))
    xd, Bc, Cc = _bf16(xd), _bf16(Bc), _bf16(Cc)
    got = emulate_bf16_kernel(xd, logdecay, Bc, Cc)
    want = ref.ssm_scan_ref(xd, logdecay, Bc, Cc)
    assert got.shape == want.shape
    assert largest_ratio(got, want) <= 1.0


# ---------------------------------------------------------------------------
# the launch plan (pure Python, mirrored by the CUDA source)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,chunks,blocks", [(4, 2048, 32, 896), (1, 8192, 128, 224)])
def test_plan_at_the_prefill_shapes(B, S, chunks, blocks):
    """zamba2-7b: 112 heads of 64, state 64; a block per half of hd."""
    assert plan(B, S, 112, 64, 64) == dict(chunk=64, chunks=chunks, cols=32, slices=2,
                                           blocks=blocks, threads=128, smem_bytes=54800)


@pytest.mark.parametrize("hd,slices", [(8, 1), (16, 1), (32, 1), (48, 2), (64, 2)])
def test_plan_slices_cover_head_dim(hd, slices):
    p = plan(2, 200, 3, hd, 24)
    assert p["slices"] == slices and p["blocks"] == 6 * slices and p["chunks"] == 4


def test_shared_bytes_let_four_blocks_share_an_sm():
    need = SMEM_BYTES + BLOCK_RESERVED_BYTES
    assert 4 * need <= SM_SMEM_BYTES < 5 * need


@pytest.mark.parametrize("hd,st,match", [
    (20, 16, "multiples of 8"),
    (64, 12, "multiples of 8"),
    (72, 64, "1..64"),
    (64, 0, "1..64"),
])
def test_plan_refuses_shapes_the_bf16_instance_cannot_take(hd, st, match):
    with pytest.raises(ValueError, match=match):
        plan(1, 64, 2, hd, st)


def test_cpu_wrapper_takes_the_plain_version_at_any_width():
    """The plan binds the card's bf16 instance only: CPU tensors of a width
    it refuses still get the plain version, and nothing launches."""
    xd, logdecay, Bc, Cc = (torch.as_tensor(a) for a in ssm_inputs(S=16, hd=20, st=12))
    n0 = ssm_scan.launches
    got = ssm_scan(xd.bfloat16(), logdecay, Bc.bfloat16(), Cc.bfloat16())
    want = ref.ssm_scan_ref(xd.bfloat16(), logdecay, Bc.bfloat16(), Cc.bfloat16())
    assert torch.equal(got, want.to(torch.bfloat16))
    assert ssm_scan.launches == n0
