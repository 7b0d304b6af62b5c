"""xLSTM blocks: the sLSTM (scalar memory, a stabilized recurrence) and the
mLSTM (matrix memory).

Prefill runs the mLSTM in its chunkwise-parallel form (the normalizer is
value channel ``hd`` of v' = [v, 1], the carried state fp32) and the sLSTM
as its exact recurrence, one Python step a position: it is sequential by
nature, and the reference's ``lax.scan`` over time becomes a loop of eager
ops.  Decode is the exact recurrence for both and updates the caches in
place.  No xLSTM op has a TPU kernel in the reference, so none reaches a
kernel here: every device runs this plain PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm

MLSTM_EXPAND = 2


def mlstm_dims(cfg: ModelConfig):
    d_inner = MLSTM_EXPAND * cfg.d_model
    hd = d_inner // cfg.num_heads
    return d_inner, cfg.num_heads, hd


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(generator, cfg: ModelConfig, dtype, device):
    """``wqkv``, ``wo_gate`` and ``out_proj`` in ``dtype``; the gate
    projection ``wif``, its bias (input gate -3, forget gate +3: a small
    input and an open forget gate at init) and ``norm`` in fp32."""
    d = cfg.d_model
    d_inner, nh, hd = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wqkv": dense_init(generator, (d, 3, nh, hd), 0, dtype, device),
        "wif": dense_init(generator, (d, 2, nh), 0, torch.float32, device),
        "if_bias": torch.cat([torch.full((1, nh), -3.0, **f32),
                              torch.full((1, nh), 3.0, **f32)]),
        "wo_gate": dense_init(generator, (d, d_inner), 0, dtype, device),
        "norm": torch.zeros(d_inner, **f32),
        "out_proj": dense_init(generator, (d_inner, d), 0, dtype, device),
    }


def _mlstm_chunked(q, k, v, logf, logi, chunk: int, init_state=None):
    """Chunkwise-parallel mLSTM.

    q, k, v: (B, S, nh, hd); logf, logi: (B, S, nh) fp32 log forget gate and
    input-gate pre-activation.  S must divide by ``chunk``.  Returns (y (B,
    S, nh, hd) in q's dtype, the final state (B, nh, hd, hd + 1) fp32)."""
    B, S, nh, hd = q.shape
    if S % chunk:
        raise ValueError(f"S={S} does not divide by the mLSTM chunk {chunk}")
    nc = S // chunk
    vp = torch.cat([v, torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)], -1)
    iw = torch.exp(logi)  # input gate weight
    qs = q.reshape(B, nc, chunk, nh, hd)
    ks = k.reshape(B, nc, chunk, nh, hd)
    vs = vp.reshape(B, nc, chunk, nh, hd + 1)
    ls = logf.reshape(B, nc, chunk, nh)
    iws = iw.reshape(B, nc, chunk, nh)
    state = (torch.zeros((B, nh, hd, hd + 1), dtype=torch.float32, device=q.device)
             if init_state is None else init_state)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=q.device))
    ys = []
    for c in range(nc):
        qf = qs[:, c].to(torch.float32) * hd ** -0.5
        kf = ks[:, c].to(torch.float32)
        vf = vs[:, c].to(torch.float32) * iws[:, c, :, :, None]
        lcum = torch.cumsum(ls[:, c], dim=1)  # (B, L, nh) inclusive
        # inter-chunk: the carried state, decayed to each position
        yin = torch.einsum("blnk,bnkv->blnv", qf * torch.exp(lcum)[..., None], state)
        # intra-chunk quadratic; the gaps above the diagonal are positive and
        # may overflow, so they are masked to -inf before the exponential:
        # the same values as the reference's where(mask, exp(gap), 0), whose
        # gradient is 0 * inf = NaN there (ROADMAP R13)
        qk = torch.einsum("bink,bjnk->bijn", qf, kf)
        gap = lcum[:, :, None, :] - lcum[:, None, :, :]  # (B, i, j, nh)
        Lm = torch.exp(torch.where(tri[None, :, :, None], gap, -torch.inf))
        yintra = torch.einsum("bijn,bjnv->binv", qk * Lm, vf)
        # the chunk's contribution to the state, decayed to the chunk's end
        tail = lcum[:, -1:, :] - lcum
        cstate = torch.einsum("bjnk,bjnv->bnkv", kf * torch.exp(tail)[..., None], vf)
        state = state * torch.exp(lcum[:, -1])[:, :, None, None] + cstate
        ys.append(yin + yintra)
    y = torch.stack(ys, dim=1).reshape(B, S, nh, hd + 1)
    num, den = y[..., :hd], y[..., hd:]
    out = num / torch.clamp(den.abs(), min=1.0)
    return out.to(q.dtype), state


def _mlstm_inputs(params, x, cfg: ModelConfig):
    """q, k, v (..., nh, hd) in x's dtype and the fp32 gate pre-activations
    (..., 2, nh) of x (..., d)."""
    d = cfg.d_model
    _, nh, hd = mlstm_dims(cfg)
    qkv = torch.matmul(x, params["wqkv"].reshape(d, 3 * nh * hd))
    q, k, v = qkv.reshape(x.shape[:-1] + (3, nh, hd)).unbind(-3)
    gates = (torch.matmul(x.to(torch.float32), params["wif"].reshape(d, 2 * nh))
             .reshape(x.shape[:-1] + (2, nh)) + params["if_bias"])
    return q, k, v, gates


def _mlstm_out(params, y, x, cfg: ModelConfig):
    """The output gate, the norm and the projection back to d_model."""
    o = torch.sigmoid(torch.matmul(x, params["wo_gate"]))
    y = rms_norm(y * o, params["norm"], cfg.norm_eps)
    return torch.matmul(y, params["out_proj"])


def mlstm_forward(params, x, cfg: ModelConfig, chunk: int = 128):
    """Training / prefill.  x: (B, S, d) -> (B, S, d); the chunk is
    ``min(chunk, S)``, and a longer S must divide by it."""
    B, S, _ = x.shape
    d_inner, _, _ = mlstm_dims(cfg)
    q, k, v, gates = _mlstm_inputs(params, x, cfg)
    logi = gates[:, :, 0]  # pre-activation input gate (log domain)
    logf = F.logsigmoid(gates[:, :, 1])
    y, _ = _mlstm_chunked(q, k, v, logf, logi, min(chunk, S))
    return _mlstm_out(params, y.reshape(B, S, d_inner), x, cfg)


def init_mlstm_cache(cfg: ModelConfig, batch: int, device):
    _, nh, hd = mlstm_dims(cfg)
    return {"C": torch.zeros((batch, nh, hd, hd + 1), dtype=torch.float32, device=device)}


def mlstm_decode(params, cache, x_t, cfg: ModelConfig):
    """Single-token recurrence.  x_t: (B, 1, d).  Updates ``cache`` in
    place: C becomes ``f C + i k [v, 1]^T``.  Returns (out (B, 1, d),
    cache)."""
    B = x_t.shape[0]
    d_inner, _, hd = mlstm_dims(cfg)
    q, k, v, gates = _mlstm_inputs(params, x_t[:, 0], cfg)
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    i = torch.exp(gates[:, 0])  # (B, nh)
    f = torch.exp(F.logsigmoid(gates[:, 1]))
    vp = torch.cat([v, torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)], -1)
    upd = (k * i[..., None])[..., :, None] * vp[..., None, :]
    C = cache["C"].mul_(f[:, :, None, None]).add_(upd)
    y = torch.einsum("bnk,bnkv->bnv", q * hd ** -0.5, C)
    num, den = y[..., :hd], y[..., hd:]
    y = (num / torch.clamp(den.abs(), min=1.0)).reshape(B, d_inner)
    return _mlstm_out(params, y.to(x_t.dtype), x_t[:, 0], cfg)[:, None], cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_dims(cfg: ModelConfig):
    hd = cfg.d_model // cfg.num_heads
    return cfg.num_heads, hd


def init_slstm(generator, cfg: ModelConfig, dtype, device):
    """The input projection ``wx`` (gates i, f, z, o), the per-head
    recurrent ``r`` (fan-in over its axis 2, scaled by 0.1) and ``bias``
    (forget gate 3: open at init) in fp32; ``out_proj`` in ``dtype``."""
    d = cfg.d_model
    nh, hd = slstm_dims(cfg)
    bias = torch.zeros((4, nh, hd), dtype=torch.float32, device=device)
    bias[1] = 3.0
    return {
        "wx": dense_init(generator, (d, 4, nh, hd), 0, torch.float32, device),
        "r": dense_init(generator, (4, nh, hd, hd), 2, torch.float32, device) * 0.1,
        "bias": bias,
        "out_proj": dense_init(generator, (d, d), 0, dtype, device),
    }


def _recurrent(params):
    """``r`` (4, nh, hd, hd) as (nh, hd, 4 hd): one batched matmul a step
    gives every gate of every head."""
    r = params["r"]
    return r.permute(1, 2, 0, 3).reshape(r.shape[1], r.shape[2], 4 * r.shape[3])


def _slstm_inputs(params, x):
    """The gate pre-activations of x (..., d) with the bias added, (..., 4,
    nh, hd) fp32."""
    wx = params["wx"]
    xg = torch.matmul(x.to(torch.float32), wx.reshape(wx.shape[0], -1))
    return xg.reshape(x.shape[:-1] + wx.shape[1:]) + params["bias"]


def _slstm_step(r, state, xb):
    """One stabilized sLSTM step.  r: ``_recurrent(params)``; state (h, c,
    n, m), each (B, nh, hd) fp32; xb: (B, 4, nh, hd) input pre-activations
    with the bias."""
    h, c, n, m = state
    B, nh, hd = h.shape
    rec = torch.bmm(h.transpose(0, 1), r).reshape(nh, B, 4, hd).permute(1, 2, 0, 3)
    pre = xb + rec
    it, ft, zt, ot = pre.unbind(1)
    logf = F.logsigmoid(ft)
    lm = logf + m
    m_new = torch.maximum(lm, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(lm - m_new)
    c_new = fp * c + ip * torch.tanh(zt)
    n_new = fp * n + ip
    h_new = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1e-6)
    return h_new, c_new, n_new, m_new


def slstm_forward(params, x, cfg: ModelConfig):
    """Training / prefill: the recurrence from a zero state (``m`` at
    -1e9), one step a position.  x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    nh, hd = slstm_dims(cfg)
    xb = _slstm_inputs(params, x)
    r = _recurrent(params)
    z = torch.zeros((B, nh, hd), dtype=torch.float32, device=x.device)
    state = (z, z, z, z - 1e9)
    hs = []
    for t in range(S):
        state = _slstm_step(r, state, xb[:, t])
        hs.append(state[0])
    y = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    return torch.matmul(y, params["out_proj"])


def init_slstm_cache(cfg: ModelConfig, batch: int, device):
    nh, hd = slstm_dims(cfg)

    def z():
        return torch.zeros((batch, nh, hd), dtype=torch.float32, device=device)

    return {"h": z(), "c": z(), "n": z(), "m": z() - 1e9}


def slstm_decode(params, cache, x_t, cfg: ModelConfig):
    """Single-token step.  x_t: (B, 1, d).  Updates ``cache`` (h, c, n, m)
    in place.  Returns (out (B, 1, d), cache)."""
    B = x_t.shape[0]
    state = _slstm_step(_recurrent(params), (cache["h"], cache["c"], cache["n"], cache["m"]),
                        _slstm_inputs(params, x_t[:, 0]))
    for key, t in zip("hcnm", state):
        cache[key].copy_(t)
    y = state[0].reshape(B, cfg.d_model).to(x_t.dtype)
    return torch.matmul(y, params["out_proj"])[:, None], cache
