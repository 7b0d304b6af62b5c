"""Mamba2 block: the chunked SSD for prefill, the recurrent step for decode.

The route is the model's ``ssm_impl`` (``kernels/ops.resolve_impl``): on
the card ``mamba2_forward`` takes y from kernel 9 (``ops.ssm_scan``); on
the CPU, or with ``ssm_impl="einsum"``, from ``ssd_chunked``, the
reference model's chunked scan in plain PyTorch.  Both compute the SSD
recurrence from a zero state.

Decode (``mamba2_decode``) is plain PyTorch on every device, as in the
reference: one recurrent step over a cache of the last ``ssm_conv - 1``
conv inputs (model dtype) and the SSM state (fp32).  It reaches no kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rms_norm


def ssm_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    nh = d_inner // cfg.ssm_head_dim
    return d_inner, nh


def init_mamba2(generator, cfg: ModelConfig, dtype, device):
    """Per-role input projections in the model's dtype; ``A_log``, ``D``,
    ``dt_bias`` and ``norm`` in fp32 whatever the model's dtype, as in the
    reference (``A_log = log(linspace(1, 16, nh))``, ``D = 1``, the others
    0)."""
    d, st = cfg.d_model, cfg.ssm_state
    d_inner, nh = ssm_dims(cfg)

    def w(shape):
        return dense_init(generator, shape, 0, dtype, device)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wz": w((d, d_inner)),
        "wx": w((d, d_inner)),
        "wB": w((d, st)),
        "wC": w((d, st)),
        "wdt": w((d, nh)),
        "conv_w": w((cfg.ssm_conv, d_inner)),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones(nh, **f32),
        "dt_bias": torch.zeros(nh, **f32),
        "norm": torch.zeros(d_inner, **f32),
        "out_proj": w((d_inner, d)),
    }


def _project(params, x):
    """Per-role input projections: z, x, B, C, dt."""
    return tuple(torch.matmul(x, params[k]) for k in ("wz", "wx", "wB", "wC", "wdt"))


def _causal_conv(x, w):
    """x: (B, S, d_inner); w: (K, d_inner) depthwise causal conv, summed
    tap by tap in x's dtype as the reference does."""
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return out


def ssd_chunked(xd, logdecay, Bc, Cc, chunk: int, init_state=None):
    """Chunked state-space dual scan, the plain route.

    xd: (B, S, nh, hd) dt-scaled inputs; logdecay: (B, S, nh), log a_t =
    dt * A (<= 0); Bc, Cc: (B, S, st), shared across heads.  S must divide
    by ``chunk``.  Returns (y (B, S, nh, hd) in xd's dtype, final_state
    (B, nh, st, hd) fp32)."""
    B, S, nh, hd = xd.shape
    st = Bc.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} does not divide by chunk={chunk}")
    nc = S // chunk
    xs = xd.reshape(B, nc, chunk, nh, hd)
    ls = logdecay.reshape(B, nc, chunk, nh)
    Bs = Bc.reshape(B, nc, chunk, st)
    Cs = Cc.reshape(B, nc, chunk, st)
    state = (torch.zeros((B, nh, st, hd), dtype=torch.float32, device=xd.device)
             if init_state is None else init_state)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=xd.device))
    ys = []
    for c in range(nc):
        xc = xs[:, c].to(torch.float32)
        bc, cc = Bs[:, c].to(torch.float32), Cs[:, c].to(torch.float32)
        lcum = torch.cumsum(ls[:, c].to(torch.float32), dim=1)  # (B, L, nh) inclusive
        # inter-chunk: y_i += C_i . (exp(lcum_i) * state_prev)
        yin = torch.einsum("bls,bnsh,bln->blnh", cc, state, torch.exp(lcum))
        # intra-chunk quadratic; the gaps above the diagonal are positive and
        # may overflow, so they are masked to -inf before the exponential:
        # the same values as the reference's where(mask, exp(gap), 0), whose
        # gradient is 0 * inf = NaN there (ROADMAP R12)
        cb = torch.einsum("bis,bjs->bij", cc, bc)
        gap = lcum[:, :, None, :] - lcum[:, None, :, :]  # (B, i, j, nh)
        L = torch.exp(torch.where(tri[None, :, :, None], gap, -torch.inf))
        yintra = torch.einsum("bij,bijn,bjnh->binh", cb, L, xc)
        # chunk state contribution
        tail = lcum[:, -1:, :] - lcum  # (B, L, nh) decay from j to the chunk's end
        cstate = torch.einsum("bjs,bjn,bjnh->bnsh", bc, torch.exp(tail), xc)
        state = state * torch.exp(lcum[:, -1])[:, :, None, None] + cstate
        ys.append((yin + yintra).to(xd.dtype))
    return torch.stack(ys, dim=1).reshape(B, S, nh, hd), state


def scan_inputs(params, x, cfg: ModelConfig):
    """Everything the prefill computes before the scan, for x (B, S, d):
    (z, xh (B, S, nh, hd), and the scan's inputs xd, logdecay, Bc, Cc)."""
    B, S, _ = x.shape
    _, nh = ssm_dims(cfg)
    z, xs, Bc, Cc, dt = _project(params, x)
    xs = F.silu(_causal_conv(xs, params["conv_w"]))
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])  # (B, S, nh)
    A = -torch.exp(params["A_log"])  # (nh,) negative
    xh = xs.reshape(B, S, nh, cfg.ssm_head_dim)
    xd = xh * dt[..., None].to(xh.dtype)
    return z, xh, xd, dt * A, Bc, Cc  # logdecay (B, S, nh) fp32


def mamba2_forward(params, x, cfg: ModelConfig, impl: str = "auto"):
    """Training / prefill.  x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    d_inner, _ = ssm_dims(cfg)
    z, xh, xd, logdecay, Bc, Cc = scan_inputs(params, x, cfg)
    if ops.resolve_impl(impl, "ssm", x.device) == "kernel":
        y = ops.ssm_scan(xd.contiguous(), logdecay.contiguous(), Bc.contiguous(),
                         Cc.contiguous(), impl="kernel")
    else:
        y, _ = ssd_chunked(xd, logdecay, Bc, Cc, min(cfg.ssm_chunk, S))
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, d_inner)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return torch.matmul(y, params["out_proj"])


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype, device):
    d_inner, nh = ssm_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode(params, cache, x_t, cfg: ModelConfig):
    """Single-token recurrent step.  x_t: (B, 1, d).  Updates ``cache`` in
    place: the conv history shifts by one input, the fp32 state becomes
    ``state * exp(dt A) + B (x dt)``.  Returns (out (B, 1, d), cache)."""
    B = x_t.shape[0]
    d_inner, nh = ssm_dims(cfg)
    z, xs, Bc, Cc, dt = _project(params, x_t[:, 0])
    # conv over (the cached K - 1 inputs, this one)
    hist = torch.cat([cache["conv"], xs[:, None, :]], dim=1)  # (B, K, d_inner)
    xs = torch.einsum("bkd,kd->bd", hist, params["conv_w"])
    cache["conv"].copy_(hist[:, 1:])
    xs = F.silu(xs)
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])  # (B, nh)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt * A)  # (B, nh)
    xh = xs.reshape(B, nh, cfg.ssm_head_dim).to(torch.float32)
    upd = torch.einsum("bs,bnh->bnsh", Bc.to(torch.float32), xh * dt[..., None])
    state = cache["ssm"].mul_(a[:, :, None, None]).add_(upd)
    y = torch.einsum("bs,bnsh->bnh", Cc.to(torch.float32), state)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(B, d_inner).to(x_t.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return torch.matmul(y, params["out_proj"])[:, None], cache
