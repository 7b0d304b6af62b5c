"""What crosses from the reference package into the port: weights and draws.

``params_from_jax`` takes the reference engine's ``template`` (or any
``{b1, b2, w1, w2}`` dict of arrays) and returns the port's params and flat
vector in the same order, so a port run can start from the reference's
init.  ``lm_params_from_jax`` does the same for the LM's ``Model`` tree,
and ``lm_cache_from_jax`` / ``lm_cache_to_numpy`` carry its decode caches
across in both directions.

The draw provider is the one place the round takes random numbers from:
``gumbel(round_idx, n)`` for selection, ``latency_factor(round_idx, n)``
for the latency jitter, ``uniform(round_idx, n, d)`` for QSGD's stochastic
rounding and ``fault_coins(round_idx, n)`` for the fault schedule's
per-round coins.  ``GeneratorDraws`` serves standalone runs from seeded
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
    ``device``: the same keys, with ``layers`` a list of ``cfg.num_layers``
    per-layer dicts (views of the stacked tensors).  Each leaf keeps its
    dtype; ``dtype`` casts the leaves that are not fp32 (in a bf16 model,
    every leaf but the norm scales, ``A_log``, ``D`` and ``dt_bias``)."""

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        t = _leaf_tensor(node)
        if dtype is not None and t.dtype != torch.float32:
            t = t.to(dtype)
        return t.to(device)

    out = {k: convert(v) for k, v in tree.items() if k != "layers"}
    stacked = convert(tree["layers"])

    def layer(node, i):
        if isinstance(node, dict):
            return {k: layer(v, i) for k, v in node.items()}
        if node.shape[0] != cfg.num_layers:
            raise ValueError(f"a layer leaf has {node.shape[0]} rows, the config "
                             f"{cfg.num_layers} layers")
        return node[i]

    out["layers"] = [layer(stacked, i) for i in range(cfg.num_layers)]
    return out


def _unstack(node, n: int, device):
    """``{name: (n, ...) array}`` -> n dicts of views of the stacked tensors."""
    stacked = {k: _leaf_tensor(v).to(device) for k, v in node.items()}
    for k, t in stacked.items():
        if t.shape[0] != n:
            raise ValueError(f"cache leaf {k!r} has {t.shape[0]} rows, expected {n}")
    return [{k: t[i] for k, t in stacked.items()} for i in range(n)]


def lm_cache_from_jax(tree, cfg, device):
    """The reference's ``Model.init_cache`` tree (numpy or JAX leaves,
    stacked on a leading layer axis) -> the port's cache on ``device``: a
    list of per-layer KV dicts for the ``attn`` kind; for ``zamba``,
    ``{"mamba": [per layer], "attn": [per shared-block application]}``.
    Each leaf keeps its dtype."""
    if "mamba" in tree:
        return {"mamba": _unstack(tree["mamba"], cfg.num_layers, device),
                "attn": _unstack(tree["attn"], cfg.num_layers // cfg.shared_attn_every,
                                 device)}
    return _unstack(tree, cfg.num_layers, device)


def lm_cache_to_numpy(cache):
    """The inverse of ``lm_cache_from_jax``: the reference's stacked tree of
    numpy arrays, bf16 leaves widened (exactly) to float32."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()

    def stack(dicts):
        return {k: np.stack([leaf(d[k]) for d in dicts]) for k in dicts[0]}

    if isinstance(cache, dict):
        return {k: stack(v) for k, v in cache.items()}
    return stack(cache)


class GeneratorDraws:
    """Per-round draws from ``torch.Generator``s seeded by
    ``(seed, round, stream)``, so a round's draws do not depend on how many
    rounds ran before it.

    The (n,) Gumbel and normal draws come from CPU generators and are moved
    to ``device``, so they are the same on every device.  The (n, d) QSGD
    uniforms (stream 2) are drawn on ``device`` itself by a generator of
    that device: at 512 clients and full width they are 52 M numbers a
    round, which the host should neither draw nor copy.  A CUDA generator
    gives other numbers than a CPU one from the same seed, so the
    standalone uniforms, and with them a compressed run, differ between CPU
    and CUDA runs."""

    def __init__(self, seed: int, device="cpu"):
        self.seed, self.device = seed, torch.device(device)

    def _generator(self, round_idx: int, stream: int,
                   device="cpu") -> torch.Generator:
        state = np.random.SeedSequence([self.seed, round_idx, stream])
        seed = int(state.generate_state(1)[0])
        return torch.Generator(device=device).manual_seed(seed)

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

    def uniform(self, round_idx: int, n: int, d: int) -> torch.Tensor:
        gen = self._generator(round_idx, 2, self.device)
        return torch.rand((n, d), generator=gen, device=self.device)

    def fault_coins(self, round_idx: int, n: int) -> torch.Tensor:
        """The (n, 2) uniform coin table of the fault schedule (stream 3)."""
        u = torch.rand((n, 2), generator=self._generator(round_idx, 3))
        return u.to(self.device)


class ReplayDraws:
    """Replays (rounds, N) arrays of Gumbel draws and latency factors and,
    optionally, a (rounds, N, D) array of uniforms and a (rounds, N, 2)
    array of fault coins, row ``round_idx`` for round ``round_idx``.

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

    def uniform(self, round_idx: int, n: int, d: int) -> torch.Tensor:
        if self._uniform is None:
            raise IndexError("no replayed uniforms were given")
        row = self._row(self._uniform, round_idx, n)
        if row.shape[1] != d:
            raise IndexError(f"replayed uniforms are {row.shape[1]} wide, not {d}")
        return row

    def fault_coins(self, round_idx: int, n: int) -> torch.Tensor:
        if self._faults is None:
            raise IndexError("no replayed fault coins were given")
        return self._row(self._faults, round_idx, n)
