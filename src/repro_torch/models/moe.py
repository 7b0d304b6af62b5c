"""Mixture-of-experts FFN: GShard-style grouped top-k dispatch with a
capacity, the reference model's ``models/moe.py`` in PyTorch.

  * routed experts, top-k as k rounds of top-1 with a per-expert fill
    counter; an assignment past the expert's capacity is dropped
  * shared (always-on) experts behind a sigmoid shared gate (Qwen2-MoE)
  * the Switch load-balance auxiliary loss, times ``router_aux_coef``
  * the parallel dense residual FFN (Snowflake Arctic) is ``blocks.py``'s

Tokens are padded to a whole number of groups of ``MAX_GROUP``; the pad
tokens route too (uniform probabilities, first-index ties) and enter the
aux loss's means, as in the reference.  Expert weights carry a leading E
axis.  ``cfg.moe_dispatch`` picks the dispatch: ``onehot`` (the default)
moves tokens in and out of the (E, G, C, d) expert slots with two dense
einsums over the (G, n, E, C) dispatch tensor; ``scatter`` indexes them.
Both compute the same function; neither reaches a kernel of the port.

Routing is discontinuous: the functions here take ``probs`` and give
bit-equal indices, slots and gates for bit-equal ``probs``
(``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does, and the
slot counts are integer cumsums).
"""
from __future__ import annotations

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models.ffn import ffn_forward, init_ffn
from repro_torch.models.layers import activation, dense_init

MAX_GROUP = 1024  # tokens per dispatch group


def init_moe(generator, cfg: ModelConfig, dtype, device):
    """The router and the shared gate in fp32, the experts' (E, ...)
    weights and the shared experts' FFN in ``dtype``."""
    E, d, ffe = cfg.num_experts, cfg.d_model, cfg.resolved_moe_d_ff
    p = {
        "router": dense_init(generator, (d, E), 0, torch.float32, device),
        "w_gate": dense_init(generator, (E, d, ffe), 1, dtype, device),
        "w_up": dense_init(generator, (E, d, ffe), 1, dtype, device),
        "w_down": dense_init(generator, (E, ffe, d), 1, dtype, device),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_ffn(generator, d, cfg.num_shared_experts * ffe, dtype, device)
        p["shared_gate"] = dense_init(generator, (d, 1), 0, torch.float32, device)
    return p


def _route_indices(probs, k: int, capacity: int):
    """probs: (G, n, E) -> (idx, pos, gate), each (G, n, k): the expert of
    each of a token's k picks in order, its slot in that expert's buffer
    (clipped to ``capacity - 1`` when dropped) and its probability, 0 for a
    dropped pick.  A group's tokens fill an expert's slots in token order,
    round after round."""
    G, _, E = probs.shape
    remaining = probs
    fill = torch.zeros((G, E), dtype=torch.int64, device=probs.device)
    experts = torch.arange(E, device=probs.device)
    idxs, poss, gates = [], [], []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)  # (G, n), the first maximum
        gate = torch.gather(remaining, -1, idx[..., None])[..., 0]
        onehot = (idx[..., None] == experts).to(torch.int64)  # (G, n, E)
        pos = torch.cumsum(onehot, dim=1) - 1 + fill[:, None, :]
        pos_tok = torch.sum(pos * onehot, dim=-1)  # (G, n)
        keep = pos_tok < capacity
        idxs.append(idx)
        poss.append(torch.clamp(pos_tok, max=capacity - 1))
        gates.append(gate * keep)
        fill = fill + torch.sum(onehot * keep[..., None], dim=1)
        remaining = remaining * (1.0 - onehot.to(probs.dtype))
    return torch.stack(idxs, -1), torch.stack(poss, -1), torch.stack(gates, -1)


def _route_topk(probs, k: int, capacity: int):
    """probs: (G, n, E) -> the dispatch tensor (G, n, E, C): the gate of
    each kept pick in its (expert, slot), 0 elsewhere.  Each (token,
    expert) takes at most one pick, so the gates are placed, not summed."""
    G, n, E = probs.shape
    idx, pos, gate = _route_indices(probs, k, capacity)
    dispatch = torch.zeros((G, n, E * capacity), dtype=torch.float32, device=probs.device)
    # a dropped pick places a gate of 0 in its clipped slot, which no
    # other pick of the token shares
    dispatch = dispatch.scatter(-1, idx * capacity + pos, gate.to(torch.float32))
    return dispatch.reshape(G, n, E, capacity)


def kept_picks(idx, gate, E: int):
    """(G, n, E) fp32 from ``_route_indices``' idx and gate: 1 where an
    expert keeps the token, 0 elsewhere."""
    picked = torch.zeros(idx.shape[:2] + (E,), dtype=torch.float32, device=idx.device)
    return picked.scatter_add(-1, idx, (gate > 0).to(torch.float32))


def route_margin(probs, k: int):
    """(G, n): the gap between each token's k-th and (k+1)-th router
    probability, how near its picks are to a tie."""
    top = torch.topk(probs, k + 1, dim=-1).values
    return top[..., k - 1] - top[..., k]


def kept_experts(params, x, cfg: ModelConfig):
    """x: (B, S, d) -> ((B S, E) bool, the experts that keep each token in
    ``moe_forward``; (B S,) each token's ``route_margin``)."""
    N, E, k = x.shape[0] * x.shape[1], cfg.num_experts, cfg.num_experts_per_tok
    _, probs, capacity = route_inputs(params, x, cfg)
    idx, _, gate = _route_indices(probs, k, capacity)
    return (kept_picks(idx, gate, E).reshape(-1, E)[:N] > 0,
            route_margin(probs, k).reshape(-1)[:N])


def _aux(probs, picked, E: int):
    """The Switch load-balance loss: E x the mean over groups of
    sum_e (mean router probability) x (share of tokens dispatched)."""
    me = torch.mean(probs, dim=1)  # (G, E)
    ce = torch.mean(picked, dim=1)  # (G, E)
    return torch.mean(torch.sum(me * ce, dim=-1)) * E


def _experts(params, xin, act: str):
    """xin (E, G, C, d) -> each expert's gated FFN of its slots."""
    f = activation(act)
    h = f(torch.einsum("egcd,edf->egcf", xin, params["w_gate"])) * torch.einsum(
        "egcd,edf->egcf", xin, params["w_up"])
    return torch.einsum("egcf,efd->egcd", h, params["w_down"])


def route_inputs(params, x, cfg: ModelConfig):
    """x: (B, S, d) -> (xt, probs, capacity): the tokens zero-padded to G
    whole groups, (G, group, d); the fp32 router probabilities, (G, group,
    E); and each expert's slots a group."""
    B, S, d = x.shape
    N = B * S
    group = min(MAX_GROUP, N)
    xt = x.reshape(N, d)
    if N % group:
        xt = torch.cat([xt, xt.new_zeros((-N % group, d))], dim=0)
    xt = xt.reshape(-1, group, d)
    logits = torch.einsum("gnd,de->gne", xt.to(torch.float32), params["router"])
    capacity = max(int(group * cfg.num_experts_per_tok * cfg.moe_capacity_factor
                       / cfg.num_experts), 4)
    return xt, torch.softmax(logits, dim=-1), capacity


def moe_forward(params, x, cfg: ModelConfig):
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, aux loss (fp32 scalar,
    times ``router_aux_coef``))."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    xt, probs, capacity = route_inputs(params, x, cfg)
    G, group = xt.shape[:2]

    if cfg.moe_dispatch == "scatter":
        idx, pos, gate = _route_indices(probs, k, capacity)  # (G, n, k)
        gate_n = (gate / (torch.sum(gate, dim=-1, keepdim=True) + 1e-9)).to(x.dtype)
        kept = gate > 0
        aux = _aux(probs, kept_picks(idx, gate, E), E)
        # each group's tokens into its (E, C) slots; a dropped pick adds a
        # zero row to its clipped slot
        g_of = torch.arange(G, device=x.device)[:, None].expand(G, group)
        xin = torch.zeros((G, E, capacity, d), dtype=x.dtype, device=x.device)
        for j in range(k):
            xin.index_put_((g_of, idx[..., j], pos[..., j]),
                           xt * kept[..., j, None].to(x.dtype), accumulate=True)
        eo = _experts(params, xin.transpose(0, 1), cfg.act).transpose(0, 1)  # (G, E, C, d)
        out = 0.0
        for j in range(k):
            out = out + gate_n[..., j, None] * eo[g_of, idx[..., j], pos[..., j]]
    else:
        dispatch = _route_topk(probs, k, capacity)  # (G, n, E, C)
        denom = torch.sum(dispatch, dim=(2, 3), keepdim=True) + 1e-9
        combine = (dispatch / denom).to(x.dtype)
        dmask = (dispatch > 0).to(x.dtype)
        aux = _aux(probs, (dispatch.sum(3) > 0).to(torch.float32), E)
        xin = torch.einsum("gnec,gnd->egcd", dmask, xt)
        eo = _experts(params, xin, cfg.act)
        out = torch.einsum("gnec,egcd->gnd", combine, eo)

    out = out.reshape(G * group, d)[:B * S].reshape(B, S, d)
    if cfg.num_shared_experts:
        sg = torch.sigmoid(torch.einsum("bsd,do->bso", x.to(torch.float32),
                                        params["shared_gate"])).to(x.dtype)
        out = out + sg * ffn_forward(params["shared"], x, cfg.act)
    return out, aux * cfg.router_aux_coef
