"""Plain PyTorch versions of the port's kernels.

The CPU path and the tests use them; ``chip_smoke.py`` holds each CUDA
kernel against them on the card.  Each mirrors the reference package's
oracle of the same name (``repro/kernels/ref.py``).

The LM kernels' plain versions take the reference's layouts: attention
q, k, v as (B, S, heads, hd), and the SSD scan's inputs as (B, S, nh, hd),
(B, S, nh) and (B, S, st).

Flat parameter layout shared with the engine: one client's params are one
``(D,)`` float32 row with the MLP's leaves in sorted-key order
``b1 (H), b2 (C), w1 (I, H), w2 (H, C)``.
"""
from __future__ import annotations

import torch


def fedavg_agg_ref(deltas, weights, staleness=None):
    """Trust-weighted (optionally staleness-decayed) server aggregation.
    deltas: (N, D); weights: (N,) -> (D,) float32."""
    w = weights.to(torch.float32)
    if staleness is not None:
        w = w * (1.0 + staleness.to(torch.float32)) ** -0.5
    return torch.einsum("n,nd->d", w, deltas.to(torch.float32))


def split_flat(flat, input_dim: int, hidden: int, classes: int) -> dict:
    """(..., D) flat rows -> dict of (..., leaf shape) views in the flat
    order ``b1, b2, w1, w2``."""
    lead = flat.shape[:-1]
    shapes = {"b1": (hidden,), "b2": (classes,), "w1": (input_dim, hidden),
              "w2": (hidden, classes)}
    out, off = {}, 0
    for k in ("b1", "b2", "w1", "w2"):
        n = 1
        for s in shapes[k]:
            n *= s
        out[k] = flat[..., off:off + n].reshape(*lead, *shapes[k])
        off += n
    return out


def local_sgd_ref(g_flat, x, y, act, mask, *, hidden: int, classes: int,
                  lr: float, batch_size: int, epochs: int, dtype=torch.float32):
    """Every client's masked local SGD from the shared global row
    ``g_flat`` (D,): E epochs of batch SGD with the hand-written gradient of
    the masked softmax cross-entropy through the Table II hidden activation
    (the fused kernel's arithmetic).  x (R, n, I), y (R, n), act (R,) int
    (0=relu, 1=softmax), mask (R, n) bool/float validity.  The sample axis
    is zero-padded to whole batches (mask-False), and a batch whose mask
    count is zero is skipped.  Returns the (R, D) post-SGD flat rows in
    ``dtype`` (float32, the kernel's type; float64 is the yardstick that the
    float32 versions' rounding is measured by)."""
    R, n, I = x.shape
    B = batch_size
    nb = -(-n // B)
    pad = nb * B - n
    x = torch.nn.functional.pad(x.to(dtype), (0, 0, 0, pad))
    y = torch.nn.functional.pad(y.to(torch.int64), (0, pad))
    m = torch.nn.functional.pad(mask.to(dtype), (0, pad))
    p = split_flat(g_flat.to(dtype), I, hidden, classes)
    w1 = p["w1"].expand(R, I, hidden).clone()
    b1 = p["b1"].expand(R, hidden).clone()
    w2 = p["w2"].expand(R, hidden, classes).clone()
    b2 = p["b2"].expand(R, classes).clone()
    soft = (act == 1).view(R, 1, 1)
    for _ in range(epochs):
        for b in range(nb):
            xb, yb, mb = (t[:, b * B:(b + 1) * B] for t in (x, y, m))
            cnt = mb.sum(1)  # (R,)
            hpre = torch.bmm(xb, w1) + b1[:, None, :]
            h = torch.where(soft, torch.softmax(hpre, -1), torch.relu(hpre))
            logits = torch.bmm(h, w2) + b2[:, None, :]
            onehot = torch.nn.functional.one_hot(yb, classes).to(dtype)
            scale = (mb / torch.clamp(cnt, min=1.0)[:, None])[..., None]
            gl = (torch.softmax(logits, -1) - onehot) * scale
            dw2 = torch.bmm(h.transpose(1, 2), gl)
            db2 = gl.sum(1)
            dh = torch.bmm(gl, w2.transpose(1, 2))
            dsoft = h * (dh - (dh * h).sum(-1, keepdim=True))
            dhp = torch.where(soft, dsoft, dh * (hpre > 0.0))
            dw1 = torch.bmm(xb.transpose(1, 2), dhp)
            db1 = dhp.sum(1)
            # an all-padding batch is skipped (exact no-op), as in the kernel
            live = (cnt > 0.0).to(dtype)
            w1 = w1 - (lr * live)[:, None, None] * dw1
            b1 = b1 - (lr * live)[:, None] * db1
            w2 = w2 - (lr * live)[:, None, None] * dw2
            b2 = b2 - (lr * live)[:, None] * db2
    return torch.cat(
        [b1, b2, w1.reshape(R, -1), w2.reshape(R, -1)], dim=1
    )


def local_sgd_ragged_ref(g_flat, xt, yt, mt, act, nb, off, *, hidden: int,
                         classes: int, lr: float, epochs: int):
    """``local_sgd_ref`` over a ragged batch-tile buffer: client r runs E
    epochs over its own ``nb[r]`` tiles ``xt[off[r] : off[r] + nb[r]]``.
    xt (T, B, I), yt (T, B), mt (T, B) bool/float validity, act / nb / off
    (R,) int.  Clients are grouped by ``nb`` and each group runs
    ``local_sgd_ref`` once, on its tiles laid end to end; a client with
    ``nb == 0`` keeps the global row.  Returns the (R, D) post-SGD rows."""
    R = act.shape[0]
    T, B, I = xt.shape
    D = hidden + classes + I * hidden + hidden * classes
    out = g_flat.to(torch.float32).expand(R, D).clone()
    nb64 = nb.to(torch.int64)
    for count in torch.unique(nb64).tolist():
        if count == 0:
            continue
        rows = torch.nonzero(nb64 == count).flatten()
        tiles = off.to(torch.int64)[rows, None] + torch.arange(
            count, device=xt.device)
        out[rows] = local_sgd_ref(
            g_flat, xt[tiles].reshape(-1, count * B, I),
            yt[tiles].reshape(-1, count * B), act[rows],
            mt[tiles].reshape(-1, count * B), hidden=hidden, classes=classes,
            lr=lr, batch_size=B, epochs=epochs,
        )
    return out


def sketch_similarity_ref(unit_loc, unit_full):
    """Defense similarity block: (M, K) @ (N, K).T -> (M, N) float32."""
    return torch.einsum(
        "mk,nk->mn", unit_loc.to(torch.float32), unit_full.to(torch.float32)
    )


def pack_codes_ref(codes, *, bits: int):
    """Offset-encoded quantization codes (n, D) int in [0, 2^bits) ->
    packed uint8.  bits=8: one code per byte (a cast).  bits=4: the row is
    zero-padded to the even width 2P, P = ceil(D / 2), and byte j holds
    code j in its low nibble and code P + j in its high nibble (half-split,
    not an even/odd interleave)."""
    c = codes.to(torch.int32)
    if bits == 8:
        return c.to(torch.uint8)
    d = c.shape[1]
    p = (d + 1) // 2
    c = torch.nn.functional.pad(c, (0, 2 * p - d))
    return (c[:, :p] | (c[:, p:] << 4)).to(torch.uint8)


def unpack_codes_ref(packed, *, bits: int, dim: int):
    """Inverse of ``pack_codes_ref``: (n, P) uint8 -> (n, dim) int32."""
    p32 = packed.to(torch.int32)
    if bits == 8:
        return p32[:, :dim]
    return torch.cat([p32 & 0xF, (p32 >> 4) & 0xF], dim=1)[:, :dim]


def topk_decode_ref(vals, idx, dim: int):
    """Sparse (n, k) value/index pairs -> dense (n, dim) float32 by
    scatter-ADD: duplicate indices accumulate; k = 0 gives zeros."""
    out = torch.zeros((vals.shape[0], dim), dtype=torch.float32,
                      device=vals.device)
    if vals.shape[1] == 0:
        return out
    return out.scatter_add_(1, idx.to(torch.int64), vals.to(torch.float32))


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, hd), k, v: (B, S, K, hd) with H % K == 0 -> (B, S, H, hd)
    in q's dtype.  Full-score softmax attention in fp32, scale hd^-1/2;
    ``causal`` masks k > q, ``window`` > 0 also masks k <= q - window
    (masked scores are -1e30).  K < H (GQA) repeats each kv head H / K
    times, as the reference's callers do before calling it."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    if G > 1:
        k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32))
    s = s * hd ** -0.5
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window:
        mask &= ki > qi - window
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32)).to(q.dtype)


def flash_attention_partials_ref(q, k, v, key_ranges, *, block_q: int,
                                 causal: bool = True, window: int = 0):
    """The fp32 kernel's key split in plain fp32: ``key_ranges[qt][p]`` is
    (lo, hi), the keys [lo, hi) of part p of query tile qt (rows qt
    ``block_q`` onwards).  For each (tile, part, row) it gives m, the
    row's largest live score in base 2 (q k hd^-1/2 log2 e), l, the sum of
    exp2(s - m) over the part's live keys, and the unnormalized output,
    the same sum of exp2(s - m) v.  A row with no live key in its part has
    m = -inf, l = 0 and a zero output.  Returns part_o (B, H, nq, P,
    block_q, hd) and part_ml (B, H, nq, P, block_q, 2); rows at or past S
    keep m = -inf."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kf = k.to(torch.float32).repeat_interleave(G, dim=2)
    vf = v.to(torch.float32).repeat_interleave(G, dim=2)
    nq, P = len(key_ranges), len(key_ranges[0])
    part_o = torch.zeros((B, H, nq, P, block_q, hd), dtype=torch.float32, device=q.device)
    part_ml = torch.zeros((B, H, nq, P, block_q, 2), dtype=torch.float32, device=q.device)
    part_ml[..., 0] = -torch.inf
    scale = hd ** -0.5 * 1.4426950408889634
    for qt in range(nq):
        r0, r1 = qt * block_q, min(S, (qt + 1) * block_q)
        qi = torch.arange(r0, r1, device=q.device)[:, None]
        for p, (lo, hi) in enumerate(key_ranges[qt]):
            hi = min(hi, S)
            if hi <= lo:
                continue
            ki = torch.arange(lo, hi, device=q.device)[None, :]
            s = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:r1].to(torch.float32),
                             kf[:, lo:hi]) * scale
            live = torch.ones((r1 - r0, hi - lo), dtype=torch.bool, device=q.device)
            if causal:
                live &= ki <= qi
            if window:
                live &= ki > qi - window
            s = torch.where(live, s, -torch.inf)
            m = s.amax(dim=-1)
            e = torch.exp2(s - torch.where(m == -torch.inf, 0.0, m)[..., None])
            part_o[:, :, qt, p, :r1 - r0] = torch.einsum("bhqk,bkhd->bhqd", e, vf[:, lo:hi])
            part_ml[:, :, qt, p, :r1 - r0, 0] = m
            part_ml[:, :, qt, p, :r1 - r0, 1] = e.sum(dim=-1)
    return part_o, part_ml


def flash_attention_merge_ref(part_o, part_ml, S: int):
    """The merge kernel's plain version: each row's parts of
    ``flash_attention_partials_ref`` weighed by exp2(m - max m) and summed
    over the parts in order, a part with m = -inf weighing 0 (so no
    exp2(-inf - -inf) reaches the sums), then divided by the weighed l.
    Returns (B, S, H, hd) float32."""
    B, H, nq, P, bq, hd = part_o.shape
    m, l = part_ml[..., 0], part_ml[..., 1]
    top = m.amax(dim=3, keepdim=True)
    w = torch.where(m == -torch.inf, 0.0,
                    torch.exp2(m - torch.where(top == -torch.inf, 0.0, top)))
    o = (w[..., None] * part_o).sum(dim=3) / (w * l).sum(dim=3).clamp_min(1e-30)[..., None]
    return o.reshape(B, H, nq * bq, hd)[:, :, :S].permute(0, 2, 1, 3).contiguous()


def ssm_scan_ref(xd, logdecay, Bc, Cc, dtype=torch.float32):
    """Sequential (exact) SSD recurrence, one step per position:
    ``state = exp(l_t) * state + B_t (x) x_t``, ``y_t = C_t . state``.
    xd: (B, S, nh, hd) dt-scaled inputs; logdecay: (B, S, nh);
    Bc, Cc: (B, S, st).  Returns y (B, S, nh, hd) in ``dtype``, the type
    every input is widened to and the state is carried in (float64 gives
    the yardstick that the float32 versions' rounding is measured by)."""
    B, S, nh, hd = xd.shape
    st = Bc.shape[-1]
    x = xd.to(dtype)
    a = torch.exp(logdecay.to(dtype))
    Bf, Cf = Bc.to(dtype), Cc.to(dtype)
    state = torch.zeros((B, nh, st, hd), dtype=dtype, device=xd.device)
    ys = []
    for t in range(S):
        upd = torch.einsum("bs,bnh->bnsh", Bf[:, t], x[:, t])
        state = state * a[:, t, :, None, None] + upd
        ys.append(torch.einsum("bs,bnsh->bnh", Cf[:, t], state))
    return torch.stack(ys, dim=1)
