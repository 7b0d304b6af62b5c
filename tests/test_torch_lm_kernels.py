"""The LM kernels' plain versions (kernels 8 and 9 of the port) against the
reference package, on the CPU.

Inputs are numpy arrays made from a seed and fed to both frameworks (bf16
cases round the same fp32 values to bf16 on both sides).  The port's
``ref.flash_attention_ref`` and ``ref.ssm_scan_ref`` are held against the
reference's jnp oracles and its Pallas kernels in interpret mode; the CUDA
kernels themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash_kernel
from repro.kernels.ssm_scan import ssm_scan as jax_ssm_kernel
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models.model import Model
from repro_torch.models.ssm import ssd_chunked

# fp32: the same function summed in another order.  bf16: both sides round
# an fp32 result to bf16 (8 bits of mantissa), so they may differ by an ulp
# of the output.
FP32_TOL = 1e-5
BF16_TOL = 1.6e-2

DTYPES = {"fp32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _both(a, dtype):
    """One numpy array as a JAX array and a torch tensor of the same dtype."""
    _, jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.as_tensor(a).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np(t):
    return t.to(torch.float32).numpy()


def qkv(B=1, S=128, H=4, K=4, hd=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, n, hd)).astype(np.float32)
                 for n in (H, K, K))


def ssm_inputs(B=2, S=64, nh=16, hd=32, st=16, seed=0):
    rng = np.random.default_rng(seed)
    xd = (rng.standard_normal((B, S, nh, hd)) * 0.5).astype(np.float32)
    # log a_t = dt * A <= 0, as the model makes it
    logdecay = -np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    Bc = (rng.standard_normal((B, S, st)) * 0.5).astype(np.float32)
    Cc = (rng.standard_normal((B, S, st)) * 0.5).astype(np.float32)
    return xd, logdecay, Bc, Cc


# ---------------------------------------------------------------------------
# kernel 8: flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("window", [0, 48])
def test_flash_attention_plain_matches_reference(dtype, window):
    """Against the jnp oracle and the Pallas kernel in interpret mode
    (32 x 32 blocks), at S = 128."""
    tol = FP32_TOL if dtype == "fp32" else BF16_TOL
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in qkv())
    got = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    assert got.dtype == tq.dtype
    _close(_np(got), jref.flash_attention_ref(jq, jk, jv, causal=True, window=window), tol)
    kern = jax_flash_kernel(jq, jk, jv, causal=True, window=window, interpret=True,
                            block_q=32, block_k=32)
    _close(_np(got), kern, tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_attention_gqa_matches_reference_with_repeat(dtype):
    """Two kv heads for four query heads: the port's wrapper and its
    ``einsum`` route take them as they are; the reference repeats them
    before the call."""
    tol = FP32_TOL if dtype == "fp32" else BF16_TOL
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in qkv(B=2, K=2, seed=1))
    want = jref.flash_attention_ref(jq, jnp.repeat(jk, 2, axis=2),
                                    jnp.repeat(jv, 2, axis=2), window=16)
    _close(_np(flash_attention(tq, tk, tv, window=16)), want, tol)
    _close(_np(ops.flash_attention(tq, tk, tv, window=16, impl="einsum")), want, tol)


def test_flash_attention_without_causal_mask_matches_reference():
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "fp32") for a in qkv(S=64, seed=2))
    want = jref.flash_attention_ref(jq, jk, jv, causal=False)
    _close(_np(ref.flash_attention_ref(tq, tk, tv, causal=False)), want, FP32_TOL)


# ---------------------------------------------------------------------------
# kernel 9: the SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_ssm_scan_plain_matches_reference(dtype):
    """The sequential recurrence on both sides (inputs widened to fp32), at
    (B, S, nh, hd, st) = (2, 64, 16, 32, 16)."""
    arrays = ssm_inputs()
    (jx, tx), (jl, tl), (jb, tb), (jc, tc) = (_both(a, dtype) if i != 1 else
                                              _both(a, "fp32")
                                              for i, a in enumerate(arrays))
    got = ref.ssm_scan_ref(tx, tl, tb, tc)
    assert got.dtype == torch.float32
    _close(got.numpy(), jref.ssm_scan_ref(jx, jl, jb, jc), FP32_TOL)


def test_ssm_scan_plain_matches_reference_kernel_and_model_scan():
    """The sequential plain version against the Pallas kernel in interpret
    mode (chunk 16, 8 heads a block) and the reference model's chunked
    scan: fp32 sums in another order over 64 steps (1e-4; 1.3e-5
    measured)."""
    xd, logdecay, Bc, Cc = ssm_inputs()
    got = ref.ssm_scan_ref(*(torch.as_tensor(a) for a in (xd, logdecay, Bc, Cc)))
    j = [jnp.asarray(a) for a in (xd, logdecay, Bc, Cc)]
    _close(got.numpy(), jax_ssm_kernel(*j, chunk=16, head_block=8, interpret=True), 1e-4)
    _close(got.numpy(), jax_ssd_chunked(*j, 16)[0], 1e-4)


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_chunked_matches_reference(chunk):
    """The port's plain model scan (the CPU route of ``mamba2_forward``)
    against the reference's: y and the final state."""
    arrays = ssm_inputs(seed=3)
    want_y, want_state = jax_ssd_chunked(*(jnp.asarray(a) for a in arrays), chunk)
    got_y, got_state = ssd_chunked(*(torch.as_tensor(a) for a in arrays), chunk)
    _close(got_y.numpy(), want_y, FP32_TOL)
    _close(got_state.numpy(), want_state, FP32_TOL)


def test_ssm_scan_wrapper_matches_plain_in_xd_dtype():
    arrays = [torch.as_tensor(a) for a in ssm_inputs(S=32, seed=4)]
    xd, logdecay, Bc, Cc = arrays
    want = ref.ssm_scan_ref(*arrays)
    assert torch.equal(ssm_scan(*arrays), want)
    assert torch.equal(ops.ssm_scan(*arrays, impl="einsum"), want)
    half = ssm_scan(xd.bfloat16(), logdecay, Bc.bfloat16(), Cc.bfloat16())
    assert half.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_cpu_wrappers_take_the_plain_version_and_launch_nothing():
    counts = (flash_attention.launches, ssm_scan.launches)
    q, k, v = (torch.as_tensor(a) for a in qkv(S=32))
    assert torch.equal(flash_attention(q, k, v), ref.flash_attention_ref(q, k, v))
    ssm_scan(*(torch.as_tensor(a) for a in ssm_inputs(S=16)))
    assert (flash_attention.launches, ssm_scan.launches) == counts


@pytest.mark.parametrize("kind", ["attn", "ssm"])
def test_kernel_route_on_cpu_raises(kind):
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.resolve_impl("kernel", kind, "cpu")
    if kind == "attn":
        q, k, v = (torch.as_tensor(a) for a in qkv(S=16))
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.flash_attention(q, k, v, impl="kernel")
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.ssm_scan(*(torch.as_tensor(a) for a in ssm_inputs(S=16)), impl="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(get_config("zamba2-7b").reduced(), device="cpu", **{f"{kind}_impl": "kernel"})


@pytest.mark.parametrize("kind", ["attn", "ssm"])
def test_resolve_impl_for_the_lm_kinds(kind):
    assert ops.resolve_impl("auto", kind, "cpu") == "einsum"
    assert ops.resolve_impl("einsum", kind, "cpu") == "einsum"
    with pytest.raises(ValueError, match=f"{kind}_impl"):
        ops.resolve_impl("pallas", kind, "cpu")
