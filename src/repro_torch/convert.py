"""What crosses from the reference package into the port: weights and draws.

``params_from_jax`` takes the reference engine's ``template`` (or any
``{b1, b2, w1, w2}`` dict of arrays) and returns the port's params and flat
vector in the same order, so a port run can start from the reference's
init.  ``lm_params_from_jax`` does the same for the LM's ``Model`` tree,
and ``lm_cache_from_jax`` / ``lm_cache_to_numpy`` carry its decode caches
across in both directions.

The draw provider is the one place the round takes random numbers from:
``gumbel(round_idx, n)`` for selection, ``latency_factor(round_idx, n)``
for the latency jitter, ``uniform(round_idx, ids, d)`` for QSGD's
stochastic rounding (one (d,) row per canonical client id in ``ids``, so
that a client block of a mesh rank draws the rows the one-device engine
draws for those clients) and ``fault_coins(round_idx, n)`` for the fault
schedule's per-round coins.  The (n,) draws are taken whole on every rank
of a mesh, from the same seed.  ``GeneratorDraws`` serves standalone runs from seeded
``torch.Generator``s; ``ReplayDraws`` replays draws made elsewhere, which is
how the parity tests feed the port the reference's threefry draws (torch
cannot reproduce those bits).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.resources import LATENCY_JITTER


def params_from_jax(tree, device="cpu"):
    """``{b1, b2, w1, w2}`` arrays (numpy or JAX) -> (params dict of float32
    tensors, (D,) flat vector in sorted-key order ``b1, b2, w1, w2``)."""
    params = {
        k: torch.as_tensor(np.array(tree[k], dtype=np.float32), device=device)
        for k in sorted(tree)
    }
    flat = torch.cat([params[k].reshape(-1) for k in sorted(params)])
    return params, flat


def params_to_numpy(params) -> dict:
    """The inverse of ``params_from_jax``: a dict of float32 numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _leaf_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16: carry its bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def lm_params_from_jax(tree, cfg, device, dtype=None):
    """The reference's ``Model.init_params`` tree (numpy or JAX leaves, layer
    params stacked on a leading L axis) -> the port's ``Model`` params on
    ``device``: the same keys, with ``layers`` a list of per-layer dicts
    (views of the stacked tensors), one per layer or, for xLSTM, one per
    (sLSTM, mLSTM) pair.  Each leaf keeps its dtype; ``dtype`` casts the
    leaves that are not fp32 (in a bf16 model, every leaf but the norm
    scales, ``A_log``, ``D``, ``dt_bias``, the MoE's ``router`` and
    ``shared_gate``, and the xLSTM's ``wx``, ``r``, ``bias``, ``wif`` and
    ``if_bias``)."""
    from repro_torch.models.model import num_blocks

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        t = _leaf_tensor(node)
        if dtype is not None and t.dtype != torch.float32:
            t = t.to(dtype)
        return t.to(device)

    out = {k: convert(v) for k, v in tree.items() if k != "layers"}
    stacked = convert(tree["layers"])

    n = num_blocks(cfg)

    def layer(node, i):
        if isinstance(node, dict):
            return {k: layer(v, i) for k, v in node.items()}
        if node.shape[0] != n:
            raise ValueError(f"a layer leaf has {node.shape[0]} rows, the config "
                             f"{n} blocks")
        return node[i]

    out["layers"] = [layer(stacked, i) for i in range(n)]
    return out


def _unstack(node, n: int, device):
    """A nest of ``{name: (n, ...) array}`` dicts -> n nests of views of the
    stacked tensors."""
    def convert(node, path):
        if isinstance(node, dict):
            return {k: convert(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        t = _leaf_tensor(node).to(device)
        if t.shape[0] != n:
            raise ValueError(f"cache leaf {path!r} has {t.shape[0]} rows, expected {n}")
        return t

    def index(node, i):
        return ({k: index(v, i) for k, v in node.items()} if isinstance(node, dict)
                else node[i])

    stacked = convert(node, "")
    return [index(stacked, i) for i in range(n)]


def lm_cache_from_jax(tree, cfg, device):
    """The reference's ``Model.init_cache`` tree (numpy or JAX leaves,
    stacked on a leading layer axis) -> the port's cache on ``device``: a
    list of per-layer dicts for the ``attn`` kind (``k`` and ``v``, or
    MLA's latent ``ckv`` and ``krope``); for ``xlstm`` a list of per-pair
    ``{"slstm": {h, c, n, m}, "mlstm": {C}}``; for ``zamba``,
    ``{"mamba": [per layer], "attn": [per shared-block application]}``.
    Each leaf keeps its dtype."""
    from repro_torch.models.model import num_blocks

    if "mamba" in tree:
        return {"mamba": _unstack(tree["mamba"], cfg.num_layers, device),
                "attn": _unstack(tree["attn"], cfg.num_layers // cfg.shared_attn_every,
                                 device)}
    return _unstack(tree, num_blocks(cfg), device)


def lm_cache_to_numpy(cache):
    """The inverse of ``lm_cache_from_jax``: the reference's stacked tree of
    numpy arrays, bf16 leaves widened (exactly) to float32."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([d[k] for d in nodes]) for k in nodes[0]}
        return np.stack([leaf(t) for t in nodes])

    if isinstance(cache, dict):
        return {k: stack(v) for k, v in cache.items()}
    return stack(cache)


_M32 = 0xFFFFFFFF
_MIX = 0x45D9F3B  # the multiplier of a well-tested 32-bit integer hash
_WEYL = 0x9E3779B1  # 2^32 / golden ratio, odd


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of each element of the int64 tensor ``h``
    (values in [0, 2^32)), in place.  Every product stays below 2^59, so
    int64 arithmetic is exact and the CPU and the card agree bit for
    bit."""
    for _ in range(2):
        h ^= h >> 16
        h.mul_(_MIX).bitwise_and_(_M32)
    h ^= h >> 16
    return h


class GeneratorDraws:
    """Per-round draws seeded by ``(seed, round, stream)``, so a round's
    draws do not depend on how many rounds ran before it.

    The (n,) Gumbel and normal draws come from CPU ``torch.Generator``s and
    are moved to ``device``, so they are the same on every device.  The
    QSGD uniforms (stream 2) are a counter hash of ``(seed, round, client
    id, coordinate)`` in int64 tensor ops on ``device`` itself: at 512
    clients and full width they are 52 M numbers a round, which the host
    should neither draw nor copy, and a client's row depends on its id
    alone, so a mesh rank draws only its own clients' rows and they equal
    the one-device run's; the CPU and the card draw the same bits."""

    def __init__(self, seed: int, device="cpu"):
        self.seed, self.device = seed, torch.device(device)
        self._columns = None  # the (d,) column hashes of the last width

    def _key(self, round_idx: int, stream: int) -> int:
        state = np.random.SeedSequence([self.seed, round_idx, stream])
        return int(state.generate_state(1)[0])

    def _generator(self, round_idx: int, stream: int) -> torch.Generator:
        return torch.Generator().manual_seed(self._key(round_idx, stream))

    def gumbel(self, round_idx: int, n: int) -> torch.Tensor:
        u = torch.rand(n, generator=self._generator(round_idx, 0))
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
        return (-torch.log(-torch.log(u))).to(self.device)

    def normal(self, round_idx: int, n: int) -> torch.Tensor:
        return torch.randn(n, generator=self._generator(round_idx, 1)).to(self.device)

    def latency_factor(self, round_idx: int, n: int) -> torch.Tensor:
        """The (n,) log-normal latency jitter ``exp(LATENCY_JITTER * z)`` of
        this round's standard-normal draw ``z``."""
        return torch.exp(LATENCY_JITTER * self.normal(round_idx, n))

    def uniform(self, round_idx: int, ids, d: int) -> torch.Tensor:
        """(len(ids), d) float32 uniforms in [0, 1): row j is client
        ``ids[j]``'s.  Element (j, c) is bits 8-31 of ``row_j * col_c mod
        2^32``, where ``row_j`` is an odd 31-bit hash of (round key, id)
        and ``col_c`` an odd 32-bit hash of the coordinate (a table kept
        across rounds): a product of two odd hashes, so each element is
        uniform and rows and columns are uncorrelated, for one multiply of
        the (n, d) block instead of a hash of every element.  The product
        stays below 2^63, exact in int64."""
        ids = torch.as_tensor(ids, device=self.device).to(torch.int64)
        row = (_mix32(ids ^ self._key(round_idx, 2)) >> 1) | 1
        if self._columns is None or self._columns.numel() != d:
            col = torch.arange(d, device=self.device, dtype=torch.int64)
            self._columns = _mix32(col.mul_(_WEYL).bitwise_and_(_M32)) | 1
        h = row[:, None] * self._columns[None, :]
        h.bitwise_and_(_M32)
        h >>= 8
        return h.to(torch.float32).mul_(2.0 ** -24)

    def fault_coins(self, round_idx: int, n: int) -> torch.Tensor:
        """The (n, 2) uniform coin table of the fault schedule (stream 3)."""
        u = torch.rand((n, 2), generator=self._generator(round_idx, 3))
        return u.to(self.device)


class ReplayDraws:
    """Replays (rounds, N) arrays of Gumbel draws and latency factors and,
    optionally, a (rounds, N, D) array of uniforms (client ``i``'s row is
    row ``i``) and a (rounds, N, 2) array of fault coins, row ``round_idx``
    for round ``round_idx``.

    The latency factors ``exp(LATENCY_JITTER * z)`` are replayed whole,
    ``exp`` included, because two libraries' ``exp`` may round the same
    argument to neighbouring floats."""

    def __init__(self, gumbel, latency, uniform=None, faults=None, device="cpu"):
        def table(a):
            return (None if a is None else
                    torch.as_tensor(np.asarray(a, np.float32), device=device))

        self._gumbel = table(gumbel)
        self._latency = table(latency)
        self._uniform = table(uniform)
        self._faults = table(faults)

    def _row(self, table, round_idx: int, n: int) -> torch.Tensor:
        if round_idx >= table.shape[0] or table.shape[1] != n:
            raise IndexError(
                f"no replayed draw for round {round_idx} of {n} clients "
                f"(have {tuple(table.shape)})"
            )
        return table[round_idx]

    def gumbel(self, round_idx: int, n: int) -> torch.Tensor:
        return self._row(self._gumbel, round_idx, n)

    def latency_factor(self, round_idx: int, n: int) -> torch.Tensor:
        return self._row(self._latency, round_idx, n)

    def uniform(self, round_idx: int, ids, d: int) -> torch.Tensor:
        if self._uniform is None:
            raise IndexError("no replayed uniforms were given")
        table = self._row(self._uniform, round_idx, self._uniform.shape[1])
        if table.shape[1] != d:
            raise IndexError(f"replayed uniforms are {table.shape[1]} wide, not {d}")
        return table[torch.as_tensor(ids, device=table.device).to(torch.int64)]

    def fault_coins(self, round_idx: int, n: int) -> torch.Tensor:
        if self._faults is None:
            raise IndexError("no replayed fault coins were given")
        return self._row(self._faults, round_idx, n)
