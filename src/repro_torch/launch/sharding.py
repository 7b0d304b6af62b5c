"""Divisibility-aware sharding policy: FSDP(data) x TP(model) [+ DP(pod)].

The reference's policy, computed on the port's trees.  ``leaf_spec``
assigns, per parameter leaf:
  * the largest dim divisible by the ``model`` axis -> tensor/expert parallel
  * the largest *remaining* dim divisible by ``data`` -> FSDP shard
  * 1-D scale/bias leaves stay replicated
A spec is a tuple with one entry per dim: an axis name, a tuple of axis
names, or None (replicated); the reference returns the same entries as a
``PartitionSpec``.

The trees differ in one way.  The reference stacks its layers on a leading
L axis under ``"layers"`` (and its decode caches on a leading L axis) and
skips that dim; the port keeps a list of per-layer dicts, so each per-layer
leaf gets the stacked leaf's spec without the L entry.

The reference's ``named`` (``NamedSharding`` over a mesh) has no
counterpart: the port has no SPMD partitioner to hand the specs to.  They
feed the dry run's per-device byte counts (``dryrun.py``).

Batch/cache specs:
  tokens (B, S)        -> (dp_axes, None)   [B==1 long-context: replicate;
                          one dp axis is its name, as in a PartitionSpec]
  kv cache (B,T,K,h)   -> B->data, K->model if divisible else T->model
  ssm cache (B,nh,..)  -> B->data, nh->model if divisible
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

from repro_torch.launch.mesh import Mesh
from repro_torch.optim.optimizers import tree_map


def _divisible(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0 and dim >= size


def leaf_spec(shape: Sequence[int], model: int, data: int) -> tuple:
    dims = list(shape)
    entries: list[Optional[str]] = [None] * len(dims)
    if len(dims) >= 2:
        # model axis: largest divisible dim (prefer trailing dims on ties --
        # contraction dims live there for our layouts)
        cands = [(dims[i], i) for i in range(len(dims)) if _divisible(dims[i], model)]
        mi = None
        if cands:
            mi = max(cands, key=lambda t: (t[0], t[1]))[1]
            entries[mi] = "model"
        cands = [(dims[i], i) for i in range(len(dims))
                 if i != mi and _divisible(dims[i], data)]
        if cands:
            di = max(cands, key=lambda t: (t[0], t[1]))[1]
            entries[di] = "data"
    return tuple(entries)


def param_specs(params_shape: Any, mesh: Mesh, *, policy: str = "fsdp_tp") -> Any:
    """Spec tree matching a params tree (tensors, ``meta`` ones included,
    or anything with a ``shape``); optimizer state trees take it too.

    policy:
      fsdp_tp  -- TP over `model` + FSDP over `data` (training default)
      tp_only  -- TP over `model`, replicated over `data`.  For inference:
                  no optimizer state exists, so paying 16x param memory
                  buys away every per-layer FSDP all-gather."""
    if policy not in ("fsdp_tp", "tp_only"):
        raise ValueError(f"unknown sharding policy {policy!r}")
    model = mesh.axis_size("model")
    data = mesh.axis_size("data") if policy == "fsdp_tp" else 1
    return tree_map(lambda leaf: leaf_spec(leaf.shape, model, data), params_shape)


def dp_axes(mesh: Mesh) -> tuple:
    """Data-parallel axes: ('pod', 'data') when a pod axis exists."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def batch_specs(batch_shape: Any, mesh: Mesh) -> Any:
    dp = dp_axes(mesh)
    dp_size = math.prod(mesh.axis_size(a) for a in dp)
    entry = dp if len(dp) > 1 else dp[0]  # as a PartitionSpec normalizes it

    def one(leaf):
        B, rest = leaf.shape[0], (None,) * (len(leaf.shape) - 1)
        if _divisible(B, dp_size):
            return (entry, *rest)
        if len(dp) == 2 and _divisible(B, dp_size // mesh.shape[0]):
            # batch divides by data but not pod*data: shard data only
            return ("data", *rest)
        return (None,) * len(leaf.shape)

    return tree_map(one, batch_shape)


def cache_specs(cache_shape: Any, mesh: Mesh) -> Any:
    """Decode-cache specs for the port's per-layer caches, leaves (B, ...)."""
    model = mesh.axis_size("model")
    data = mesh.axis_size("data")

    def one(leaf):
        dims = list(leaf.shape)
        entries: list[Optional[str]] = [None] * len(dims)
        if len(dims) >= 1 and _divisible(dims[0], data):
            entries[0] = "data"  # batch
        # model axis: kv caches (B,T,K,hd) prefer heads K, then length T;
        # ssm/latent caches prefer the first non-batch dim.  Never shard the
        # trailing feature dim.
        order = [2, 1] if len(dims) == 4 else list(range(1, len(dims) - 1))
        for i in order:
            if i < len(dims) and entries[i] is None and _divisible(dims[i], model):
                entries[i] = "model"
                break
        return tuple(entries)

    return tree_map(one, cache_shape)
