"""Optimizers over the port's parameter trees: SGD, momentum, AdamW.

The API mirrors the reference's (and optax's): ``opt.init(params) ->
state``, ``opt.update(grads, state, params, step) -> (updates, state)``,
where the updates are ADDED to the params (``apply_updates``).  A tree is
what ``models/model.py`` builds: dicts and lists of tensors (the LM's
``layers`` a list of per-layer dicts).  Optimizer state mirrors the param
tree, so the sharding policy's param specs apply to it verbatim.

Each leaf is updated by plain tensor ops; there is no kernel here (the
reference has none either).  Dtypes follow the reference's AdamW: ``m``
and ``v`` are fp32, the update is computed in fp32 and cast to the param's
dtype, and it is added in that dtype, so bf16 params stay bf16 with no fp32
master copy.  SGD and momentum keep every leaf in its param's dtype too,
and a clipped gradient keeps its own (the reference's clip promotes bf16
gradients to fp32, and with them its SGD and momentum updates and params;
in fp32 the two agree).  A constant learning rate is a Python float that
enters a leaf's update in the leaf's dtype, as the reference's weak-typed
scalar does; a scheduled one is a 0-d fp32 tensor.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.common.config import TrainConfig
from repro_torch.core.engine import ordered_leaves


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params, step) -> (updates, state)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of the same-shaped trees
    ``rest``), keeping the dict / list / tuple structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _global_norm(tree):
    """The fp32 L2 norm of every leaf of ``tree`` together."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for _, leaf in ordered_leaves(tree)))


def _clip(grads, max_norm):
    if not max_norm:
        return grads
    gn = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads)


def _step_of(lr, t):
    """``-lr * t`` in ``t``'s dtype: a Python float ``lr`` rounded to that
    dtype first (the reference's weak-typed scalar), a tensor ``lr`` in
    fp32 and then cast."""
    if isinstance(lr, torch.Tensor):
        return (-lr * t.to(torch.float32)).to(t.dtype)
    return torch.tensor(-lr, dtype=t.dtype) * t


def make_optimizer(tc: TrainConfig, schedule=None) -> Optimizer:
    """SGD, momentum or AdamW from ``tc`` (``tc.optimizer``), with the
    global-norm clip ``tc.grad_clip`` (0: none) and the learning rate
    ``schedule(step)`` (default: ``tc.lr`` at every step)."""
    if schedule is None:

        def schedule(step):
            return tc.lr

    if tc.optimizer == "sgd":

        def init(params):
            return ()

        def update(grads, state, params, step):
            grads = _clip(grads, tc.grad_clip)
            lr = schedule(step)
            return tree_map(lambda g: _step_of(lr, g), grads), state

        return Optimizer(init, update)

    if tc.optimizer == "momentum":

        def init(params):
            return {"mu": tree_map(torch.zeros_like, params)}

        def update(grads, state, params, step):
            grads = _clip(grads, tc.grad_clip)
            lr = schedule(step)
            mu = tree_map(lambda m, g: tc.momentum * m + g, state["mu"], grads)
            return tree_map(lambda m: _step_of(lr, m), mu), {"mu": mu}

        return Optimizer(init, update)

    if tc.optimizer == "adamw":

        def init(params):
            zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

        def update(grads, state, params, step):
            grads = _clip(grads, tc.grad_clip)
            lr = schedule(step)
            t = torch.as_tensor(step, dtype=torch.float32) + 1.0
            m = tree_map(lambda m_, g: tc.b1 * m_ + (1 - tc.b1) * g.to(torch.float32),
                         state["m"], grads)
            v = tree_map(lambda v_, g: tc.b2 * v_
                         + (1 - tc.b2) * torch.square(g.to(torch.float32)),
                         state["v"], grads)
            bc1 = 1 - torch.pow(torch.tensor(tc.b1, dtype=torch.float32), t)
            bc2 = 1 - torch.pow(torch.tensor(tc.b2, dtype=torch.float32), t)

            def upd_fn(m_, v_, p):
                u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + tc.eps)
                u = u + tc.weight_decay * p.to(torch.float32)
                return (-lr * u).to(p.dtype)

            return tree_map(upd_fn, m, v, params), {"m": m, "v": v}

        return Optimizer(init, update)

    raise ValueError(f"unknown optimizer {tc.optimizer!r}")


def apply_updates(params, updates):
    """``params + updates`` leaf by leaf, in each param's dtype."""
    return tree_map(lambda p, u: p + u, params, updates)
