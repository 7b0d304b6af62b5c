"""Checkpoints: a state tree to one file and back.

``save`` flattens a tree (dicts, NamedTuples, lists / tuples) of tensors,
numpy arrays and Python scalars to ``{path: tensor}`` records, ``path`` the
keys / field names / indices joined by ``/``, and writes ``{"step": step,
"records": records}`` with ``torch.save`` to ``path + ".tmp"``, then
renames it over ``path`` (a crash mid-write leaves the old file).
``restore`` reads the records back with ``torch.load(weights_only=True)``
and rebuilds a tree shaped like a template: each leaf takes the template
leaf's kind (a tensor on the template tensor's device, a numpy array, a
Python number) and keeps the dtype it was saved with (bf16 included).  A
record missing for a template leaf, or of another shape, raises
``ValueError``.

The file format is this package's own.  It does not read the reference
package's msgpack checkpoints, and it needs no ``msgpack``.

``save_store`` / ``restore_store`` checkpoint the cohort engine's
``ClientStore`` (``core/client_store.py``), optionally with the (D,) global
model, so that one file resumes a cohort run.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


def _leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of ``tree`` in a fixed order: dict keys sorted,
    NamedTuple fields and sequence items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def _rebuild(tree, leaf_fn, prefix: str = ""):
    """``tree`` with every leaf replaced by ``leaf_fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaf_fn, f"{prefix}{k}/") for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, k), leaf_fn, f"{prefix}{k}/")
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaf_fn, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return leaf_fn(prefix.rstrip("/"), tree)


def _record(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    if isinstance(leaf, (np.ndarray, np.generic)):
        arr = np.asarray(leaf)
        if not (arr.flags.c_contiguous and arr.flags.writeable):
            arr = arr.copy()
        return torch.from_numpy(arr)
    return torch.tensor(leaf)


def save(path: str, tree: Any, *, step: int = 0) -> None:
    """Write ``tree`` to ``path`` (atomically, through ``path + ".tmp"``)."""
    records = {name: _record(leaf) for name, leaf in _leaves(tree)}
    tmp = path + ".tmp"
    torch.save({"step": int(step), "records": records}, tmp)
    os.replace(tmp, path)


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _restore(payload: dict, template: Any, path: str):
    records = payload["records"]

    def leaf(name, tmpl):
        rec = records.get(name)
        if rec is None:
            raise ValueError(
                f"checkpoint {path!r} has no record for {name!r}: it was "
                f"written from a tree without that leaf"
            )
        shape = tuple(np.shape(tmpl))
        if tuple(rec.shape) != shape:
            raise ValueError(f"shape mismatch for {name}: {tuple(rec.shape)} "
                             f"vs {shape}")
        if isinstance(tmpl, torch.Tensor):
            return rec.to(tmpl.device)
        if isinstance(tmpl, (np.ndarray, np.generic)):
            return rec.numpy()
        return type(tmpl)(rec.item())

    return _rebuild(template, leaf)


def restore(path: str, template: Any):
    """Read ``path`` into a tree shaped like ``template`` -> (tree, step)."""
    payload = _load(path)
    return _restore(payload, template, path), payload["step"]


def save_store(path: str, store, *, params=None, step: int = 0) -> None:
    """Checkpoint a ``ClientStore`` mid-run, with the (D,) global model
    ``params`` when given.  On a client mesh every rank holds the same
    store: every rank calls this, rank 0 writes, and the ranks wait for
    the file before any goes on."""
    meshed = dist.is_available() and dist.is_initialized()
    if not meshed or dist.get_rank() == 0:
        tree = {"store": store.state_dict()}
        if params is not None:
            tree["params"] = params
        save(path, tree, step=step)
    if meshed:
        dist.barrier()


def restore_store(path: str, store, *, with_params: bool = False):
    """Restore a ``save_store`` checkpoint INTO ``store`` (in place, each
    column's shape checked) -> ``(params, step)``: ``params`` the saved flat
    model as a CPU tensor when ``with_params`` (the file must hold one),
    else ``None``."""
    payload = _load(path)
    template = {"store": store.state_dict()}
    if with_params:
        rec = payload["records"].get("params")
        if rec is None:
            raise ValueError(f"{path} holds no bundled params")
        template["params"] = torch.zeros(rec.shape, dtype=rec.dtype)
    tree = _restore(payload, template, path)
    store.load_state_dict(tree["store"])
    return tree.get("params"), payload["step"]
