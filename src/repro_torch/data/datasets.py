"""Federated dataset subsystem (numpy, bit-identical to the reference's).

``make_federated(name, num_clients, **knobs)`` resolves a builder from the
registry and returns a ``FederatedDataset``: client-indexed ``(x, y)``
shards plus per-client metadata, ready for ``FedAREngine.prepare_data``.

Builders:

  ``table2``   -- the paper's exact 12-robot fleet (Table II).
  ``scaled``   -- Table II tiled to any fleet size.
  ``sybil``    -- the tiled honest fleet plus a replica sybil clique (the
                  defense demo's threat model); knob ``num_sybils``
                  (default N / 4).
  ``digits`` / ``mnist`` / ``emnist``
               -- pool datasets: a sample pool from ``data/sources.py``
                  (real IDX files from the local cache, or the
                  deterministic offline fallback; never the network) split
                  by a named non-IID scenario from ``data/scenarios.py``
                  (``iid``, ``label_skew``, ``quantity_skew``,
                  ``robot_drift``).

Pool datasets are ragged (clients hold different sample counts), so shards
are zero-padded to a rectangle and carry a ``mask``; ``sizes`` holds the
true n_u for aggregation weighting.  ``robot_drift`` also carries a
``round_mask`` (windows, N, n) schedule: round t trains on window
``t mod windows``.  ``packed_arrays`` builds the padding-free bucketed
layout the engine's packed path takes, and ``cohort_arrays`` the K clients
of one cohort-engine round.  ``VirtualFleet`` is a lazy fleet of any size
for the cohort engine: it keeps 24 profile shards on the device and
materializes only each round's cohort.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.resources import POISON_FRAC
from repro_torch.data.federated import scaled_fleet, sybil_fleet, table2_fleet
from repro_torch.data.scenarios import (
    bucket_widths,
    make_scenario,
    pick_layout,
    plan_sizes,
)
from repro_torch.data.sources import ArraySource, get_source


def inert_clients(count: int, samples: int, dim: int, *, windows: int = 0,
                  x_dtype=np.float32, y_dtype=np.int32) -> dict:
    """``count`` clients that can never contribute to a round: all-False
    sample ``mask`` (the masked local-SGD delta is exactly zero) and
    ``sizes == 0`` (aggregation weight exactly zero).  Used for mesh padding
    (``padded_to``), bucket fill rows (``packed_arrays``) and the cohort
    underfill (``cohort_arrays``); an all-False ``round_mask`` rides along
    when ``windows > 0``."""
    out = {
        "x": np.zeros((count, samples, dim), x_dtype),
        "y": np.zeros((count, samples), y_dtype),
        "sizes": np.zeros((count,), np.float32),
        "activations": np.zeros((count,), np.int32),
        "mask": np.zeros((count, samples), bool),
    }
    if windows:
        out["round_mask"] = np.zeros((windows, count, samples), bool)
    return out


def corrupt_clients(ds: "FederatedDataset", which, fill) -> "FederatedDataset":
    """Copy of ``ds`` whose clients in the ``which`` mask carry garbage
    sample features (``fill``: NaN, +-Inf or a huge finite value), so that
    local SGD makes a garbage delta through the real training path: the
    data-side counterpart of the engine's corrupt-uplink fault."""
    which = np.asarray(which, bool)
    if which.shape != (ds.num_clients,):
        raise ValueError(
            f"corrupt_clients: mask shape {which.shape} vs fleet "
            f"({ds.num_clients},)"
        )
    x = np.array(ds.x)
    x[which] = np.float32(fill)
    return replace(ds, x=x)


@dataclass
class FederatedDataset:
    """Client-indexed shards + metadata.  ``arrays()`` yields the engine's
    dense data dict; ``mask`` / ``round_mask`` ride along only when set."""

    name: str
    x: np.ndarray  # (N, n, 784) float32
    y: np.ndarray  # (N, n) int32
    sizes: np.ndarray  # (N,) float32 true per-client sample counts
    activations: np.ndarray  # (N,) int32 0=relu 1=softmax
    scenario: Optional[str] = None
    mask: Optional[np.ndarray] = None  # (N, n) bool valid-sample mask
    round_mask: Optional[np.ndarray] = None  # (W, N, n) bool drift schedule
    poisoners: Optional[np.ndarray] = None  # (N,) bool
    fallback: bool = False
    num_classes: int = 10
    meta: dict = field(default_factory=dict)

    @property
    def num_clients(self) -> int:
        return self.x.shape[0]

    @property
    def samples(self) -> int:
        return self.x.shape[1]

    @property
    def windows(self) -> int:
        return 0 if self.round_mask is None else self.round_mask.shape[0]

    def arrays(self) -> dict:
        out = {
            "x": self.x,
            "y": self.y,
            "sizes": self.sizes,
            "activations": self.activations,
        }
        if self.mask is not None:
            out["mask"] = self.mask
        if self.round_mask is not None:
            out["round_mask"] = self.round_mask
        return out

    def padded_to(self, multiple: int) -> "FederatedDataset":
        """Pad the fleet with inert dummy clients (``inert_clients``) to the
        next multiple of ``multiple``; the engine's ``num_clients`` must be
        the padded count."""
        if multiple < 1:
            raise ValueError(f"padded_to: multiple must be >= 1, got "
                             f"{multiple}")
        N = self.num_clients
        pad = (-N) % multiple
        if pad == 0:
            return self
        blank = inert_clients(pad, self.samples, self.x.shape[2],
                              windows=self.windows, x_dtype=self.x.dtype,
                              y_dtype=self.y.dtype)
        mask = (
            np.ones((N, self.samples), bool) if self.mask is None
            else self.mask
        )
        return FederatedDataset(
            name=self.name,
            x=np.concatenate([self.x, blank["x"]]),
            y=np.concatenate([self.y, blank["y"]]),
            sizes=np.concatenate([self.sizes,
                                  blank["sizes"].astype(self.sizes.dtype)]),
            activations=np.concatenate([self.activations,
                                        blank["activations"]]),
            scenario=self.scenario,
            mask=np.concatenate([mask, blank["mask"]]),
            round_mask=None if self.round_mask is None else np.concatenate(
                [self.round_mask, blank["round_mask"]], axis=1
            ),
            poisoners=None if self.poisoners is None
            else np.concatenate([self.poisoners, np.zeros(pad, bool)]),
            fallback=self.fallback,
            num_classes=self.num_classes,
            meta={**self.meta, "real_clients": N, "padded_clients": pad},
        )

    def cohort_arrays(self, idx, valid=None) -> dict:
        """The (K,) cohort ``idx``'s shards, for the cohort engine: the K
        clients' arrays, with underfill slots (``valid`` False) replaced by
        ``inert_clients``.  ``cohort_valid`` (the host's selection) and a
        sample ``mask`` (all True on maskless fleets) are always present."""
        idx = np.asarray(idx)
        k = idx.shape[0]
        valid = (np.ones((k,), bool) if valid is None
                 else np.asarray(valid, bool))
        out = {
            "x": self.x[idx],
            "y": self.y[idx],
            "sizes": self.sizes[idx].astype(np.float32),
            "activations": self.activations[idx],
            "mask": (np.ones((k, self.samples), bool) if self.mask is None
                     else self.mask[idx]),
            "cohort_valid": valid,
        }
        if self.round_mask is not None:
            out["round_mask"] = self.round_mask[:, idx]
        hole = ~valid
        if hole.any():
            blank = inert_clients(int(hole.sum()), self.samples,
                                  self.x.shape[2], windows=self.windows,
                                  x_dtype=self.x.dtype, y_dtype=self.y.dtype)
            for key in ("x", "y", "sizes", "activations", "mask"):
                out[key][hole] = blank[key]
            if self.round_mask is not None:
                out["round_mask"][:, hole] = blank["round_mask"]
        return out

    def client_extents(self) -> np.ndarray:
        """(N,) highest valid sample position + 1 per client: the width the
        packed layout must keep (the full rectangle on maskless fleets)."""
        if self.mask is None:
            return np.full(self.num_clients, self.samples, np.int64)
        live = self.mask
        if self.round_mask is not None:
            live = live | self.round_mask.any(axis=0)
        rev = live[:, ::-1]
        extent = self.samples - rev.argmax(axis=1)
        return np.where(live.any(axis=1), extent, 1).astype(np.int64)

    def packed_arrays(self, shards: int = 1, min_width: int = 16,
                      quantum: Optional[int] = None) -> dict:
        """The padding-free engine layout: clients sorted into power-of-two
        width buckets (``scenarios.bucket_widths``).

        ``packed`` holds, per bucket b, ``x`` (rows_b, L_b, dim), ``y``,
        ``mask`` (and ``round_mask`` (W, rows_b, L_b) under drift), ``perm``
        (rows_b,) the canonical client of each row within its shard block,
        ``valid`` the real rows, ``act`` the activation ids; ``inv`` (N,)
        maps each canonical client to its row in the shard-local
        concatenation of the buckets; ``n_max`` (float32) is the dense
        rectangle width, ``shards`` the shard count the layout is built for.
        Rows are laid out shard-major with per-shard row counts equalized by
        inert fill rows (all-False mask).  A fleet whose ``num_clients``
        does not divide by ``shards`` is padded first (``padded_to``)."""
        if shards < 1:
            raise ValueError(f"packed_arrays: shards must be >= 1, got "
                             f"{shards}")
        if self.num_clients % shards:
            return self.padded_to(shards).packed_arrays(
                shards=shards, min_width=min_width, quantum=quantum
            )
        N, n = self.num_clients, self.samples
        blk = N // shards
        extent = self.client_extents()
        width = bucket_widths(extent, n, min_width=min_width,
                              quantum=quantum).astype(int)
        widths = sorted(set(width.tolist()))
        dim = self.x.shape[2]
        W = self.windows
        ids = {
            L: [
                [i for i in range(s * blk, (s + 1) * blk) if width[i] == L]
                for s in range(shards)
            ]
            for L in widths
        }
        caps = {L: max(len(lst) for lst in ids[L]) for L in widths}
        offsets = np.cumsum([0] + [caps[L] for L in widths[:-1]])
        inv = np.zeros((N,), np.int32)
        for bi, L in enumerate(widths):
            for s in range(shards):
                for j, cid in enumerate(ids[L][s]):
                    inv[cid] = offsets[bi] + j
        px, py, pm, pperm, pvalid, pact, prm = [], [], [], [], [], [], []
        for L in widths:
            rows = shards * caps[L]
            blank = inert_clients(rows, L, dim, windows=W)
            xb, yb, mb = blank["x"], blank["y"], blank["mask"]
            act = blank["activations"]
            rmb = blank["round_mask"] if W else None
            perm = np.zeros((rows,), np.int32)
            valid = np.zeros((rows,), bool)
            for s in range(shards):
                for j, cid in enumerate(ids[L][s]):
                    r = s * caps[L] + j
                    xb[r] = self.x[cid, :L]
                    yb[r] = self.y[cid, :L]
                    mb[r] = True if self.mask is None else self.mask[cid, :L]
                    if rmb is not None:
                        rmb[:, r] = self.round_mask[:, cid, :L]
                    perm[r] = cid - s * blk
                    valid[r] = True
                    act[r] = self.activations[cid]
            px.append(xb)
            py.append(yb)
            pm.append(mb)
            pperm.append(perm)
            pvalid.append(valid)
            pact.append(act)
            if rmb is not None:
                prm.append(rmb)
        packed = {
            "x": tuple(px),
            "y": tuple(py),
            "mask": tuple(pm),
            "perm": tuple(pperm),
            "valid": tuple(pvalid),
            "act": tuple(pact),
            "inv": inv,
            "n_max": np.float32(n),
            "shards": np.int32(shards),
        }
        if prm:
            packed["round_mask"] = tuple(prm)
        return {
            "sizes": self.sizes,
            "activations": self.activations,
            "packed": packed,
        }

    def engine_arrays(self, shards: int = 1, min_width: int = 16,
                      quantum: Optional[int] = None,
                      layout: str = "auto") -> dict:
        """The engine data dict under a named layout: ``"dense"``
        (``arrays()``), ``"packed"`` (``packed_arrays``), or ``"auto"``,
        picked per fleet by ``scenarios.pick_layout``."""
        if layout == "auto":
            layout = pick_layout(self.client_extents(), self.samples,
                                 min_width=min_width, quantum=quantum)
        if layout == "packed":
            return self.packed_arrays(shards=shards, min_width=min_width,
                                      quantum=quantum)
        if layout != "dense":
            raise ValueError(
                f"unknown layout {layout!r}: expected auto | dense | packed"
            )
        return self.padded_to(shards).arrays()


class VirtualFleet:
    """Lazy synthetic fleet for the cohort engine: ``num_clients`` is a
    property of this object, never of a materialized (N, n, dim) array.
    Client ``i`` inherits Table II profile ``i % 12`` (the ``scaled``
    fleet's layout) and the last ``num_poisoners`` clients are
    label-flipped, but only the 24 distinct profile shards (12 honest, the
    same 12 flipped) are kept, plus one inert row (``inert_clients``), as
    one (25, n, dim) table on ``device`` (``None`` means the card, which
    raises without one).  ``cohort_arrays`` moves only the (K,) row indices
    to the device and gathers there; ``materialize()`` is the dense
    whole-fleet view for the K >= N resident path."""

    def __init__(self, num_clients: int, *, samples_per_client: int = 200,
                 num_poisoners: Optional[int] = None, flip_frac: float = 0.6,
                 seed: int = 0, source=None, device=None):
        from repro_torch.core.engine import resolve_device

        if num_poisoners is None:
            num_poisoners = int(round(num_clients * POISON_FRAC))
        if num_poisoners > num_clients:
            raise ValueError(
                f"num_poisoners={num_poisoners} exceeds the "
                f"{num_clients}-client fleet"
            )
        self.name = "virtual"
        self.num_clients = num_clients
        self.num_poisoners = num_poisoners
        self.seed = seed
        self.scenario = None
        self.fallback = False
        self.device = resolve_device(device)
        # rows 0-11: the honest Table II profiles; 12-23: the same profiles
        # with the poisoners' label flip
        self._base = scaled_fleet(
            24, seed=seed, num_poisoners=12, flip_frac=flip_frac,
            samples_per_client=samples_per_client, source=source,
        )
        blank = inert_clients(1, self.samples, self._base["x"].shape[2])

        def table(key, dtype):
            rows = np.concatenate([np.asarray(self._base[key]), blank[key]])
            return torch.as_tensor(rows.astype(dtype), device=self.device)

        self._table = {"x": table("x", np.float32), "y": table("y", np.int32),
                       "sizes": table("sizes", np.float32),
                       "activations": table("activations", np.int32)}

    @property
    def samples(self) -> int:
        return self._base["x"].shape[1]

    @property
    def windows(self) -> int:
        return 0

    @property
    def poisoners(self) -> np.ndarray:
        mask = np.zeros(self.num_clients, bool)
        if self.num_poisoners:
            mask[-self.num_poisoners:] = True
        return mask

    def _profiles(self, idx) -> np.ndarray:
        """client id -> profile row: honest clients map to their tiled
        Table II profile, the poisoned tail to its flipped twin."""
        idx = np.asarray(idx)
        poisoned = idx >= self.num_clients - self.num_poisoners
        return np.where(poisoned, idx % 12 + 12, idx % 12).astype(np.int64)

    def cohort_arrays(self, idx, valid=None) -> dict:
        """The cohort's shards as tensors on the fleet's device, gathered
        there from the profile table; invalid slots read the inert row 24
        (all-False mask, zero sizes)."""
        prof = self._profiles(idx)
        k = prof.shape[0]
        valid = (np.ones((k,), bool) if valid is None
                 else np.asarray(valid, bool))
        rows = torch.as_tensor(np.where(valid, prof, 24), device=self.device)
        vld = torch.as_tensor(valid, device=self.device)
        out = {key: t[rows] for key, t in self._table.items()}
        out["mask"] = vld[:, None].expand(k, self.samples).contiguous()
        out["cohort_valid"] = vld
        return out

    def materialize(self) -> FederatedDataset:
        """The dense whole-fleet view (a host-side profile gather), for
        small fleets; maskless, so the resident engine runs its dense
        path."""
        prof = self._profiles(np.arange(self.num_clients))
        return FederatedDataset(
            name="virtual",
            x=self._base["x"][prof],
            y=self._base["y"][prof],
            sizes=self._base["sizes"][prof].astype(np.float32),
            activations=self._base["activations"][prof],
            poisoners=self.poisoners,
            meta={"profiles": 24, "seed": self.seed},
        )


BUILDERS: Dict[str, Callable] = {}


def register_builder(name: str):
    def deco(fn):
        BUILDERS[name] = fn
        return fn

    return deco


def make_federated(name: str, num_clients: int = 12, **knobs
                   ) -> FederatedDataset:
    """Build a named federated dataset (see the module docstring); unknown
    knobs raise from the builder."""
    try:
        builder = BUILDERS[name]
    except KeyError:
        raise KeyError(
            f"unknown federated dataset {name!r}; registered: "
            f"{sorted(BUILDERS)}"
        ) from None
    return builder(num_clients, **knobs)


def _poison_mask(num_clients: int, poisoners) -> np.ndarray:
    mask = np.zeros(num_clients, bool)
    mask[list(poisoners)] = True
    return mask


@register_builder("table2")
def _table2(num_clients, *, seed=0, poisoners=(10, 11), flip_frac=0.6,
            samples_per_client=None, source="synthetic", cache_dir=None):
    if num_clients != 12:
        raise ValueError(
            f"table2 is the paper's 12-robot fleet, got num_clients="
            f"{num_clients} (use 'scaled' for other sizes)"
        )
    src = get_source(source, cache_dir=cache_dir)
    data = table2_fleet(seed=seed, poisoners=poisoners, flip_frac=flip_frac,
                        samples_per_client=samples_per_client, source=src)
    return FederatedDataset(
        name="table2", **data, poisoners=_poison_mask(12, poisoners),
        fallback=src.fallback, meta={"source": src.name},
    )


@register_builder("scaled")
def _scaled(num_clients, *, seed=0, num_poisoners=None, flip_frac=0.6,
            samples_per_client=200, source="synthetic", cache_dir=None):
    src = get_source(source, cache_dir=cache_dir)
    data, poison = scaled_fleet(
        num_clients, seed=seed, num_poisoners=num_poisoners,
        flip_frac=flip_frac, samples_per_client=samples_per_client,
        return_poisoners=True, source=src,
    )
    return FederatedDataset(
        name="scaled", **data, poisoners=poison, fallback=src.fallback,
        meta={"source": src.name},
    )


@register_builder("sybil")
def _sybil(num_clients, *, num_sybils=None, seed=0, samples_per_client=200,
           flip_frac=1.0, target_shift=1, source="synthetic", cache_dir=None):
    src = get_source(source, cache_dir=cache_dir)
    if num_sybils is None:
        num_sybils = num_clients // 4
    data, sybils = sybil_fleet(
        num_clients, num_sybils, seed=seed,
        samples_per_client=samples_per_client, flip_frac=flip_frac,
        target_shift=target_shift, source=src,
    )
    return FederatedDataset(
        name="sybil", **data, poisoners=sybils, fallback=src.fallback,
        meta={"source": src.name, "num_sybils": num_sybils},
    )


def _assemble(name, scenario, px, py, plan, num_clients, *, seed,
              fallback, num_classes, meta):
    """Turn a ragged ScenarioPlan over pool arrays into rectangular padded
    shards with validity masks (and the drift round_mask schedule)."""
    counts = plan_sizes(plan)
    n_max = max(1, int(counts.max(initial=0)))
    dim = px.shape[1]
    x = np.zeros((num_clients, n_max, dim), np.float32)
    y = np.zeros((num_clients, n_max), np.int32)
    mask = np.zeros((num_clients, n_max), bool)
    for i, ci in enumerate(plan.client_indices):
        x[i, : len(ci)] = px[ci]
        y[i, : len(ci)] = py[ci]
        mask[i, : len(ci)] = True
    round_mask = None
    if plan.window_indices is not None:
        windows = len(plan.window_indices[0])
        round_mask = np.zeros((windows, num_clients, n_max), bool)
        for i, wins in enumerate(plan.window_indices):
            off = 0
            for w, win in enumerate(wins):  # window-major client layout
                round_mask[w, i, off: off + len(win)] = True
                off += len(win)
    # Table II assigns softmax/relu activations randomly per robot
    rng = np.random.default_rng(seed + 13)
    activations = rng.integers(0, 2, num_clients).astype(np.int32)
    return FederatedDataset(
        name=name, scenario=scenario, x=x, y=y,
        sizes=np.asarray(counts, np.float32), activations=activations,
        mask=mask, round_mask=round_mask, fallback=fallback,
        num_classes=num_classes, meta=meta,
    )


def _pool_builder(dataset: str):
    def build(num_clients, *, scenario="label_skew", samples_per_client=200,
              seed=0, cache_dir=None, **scenario_knobs):
        src = get_source(dataset, cache_dir=cache_dir)
        if isinstance(src, ArraySource):
            px, py = src.x, src.y
        else:
            # the synthetic or fallback pool, sized to the fleet's demand
            pool_n = max(num_clients * (samples_per_client or 200), 2048)
            px, py = src.sample(pool_n, seed=seed * 7919 + 11)
        plan = make_scenario(scenario, py, num_clients, samples_per_client,
                             seed=seed, **scenario_knobs)
        return _assemble(
            dataset, scenario, px, py, plan, num_clients, seed=seed,
            fallback=src.fallback, num_classes=src.num_classes,
            meta={"source": src.name, "pool_size": len(py), **scenario_knobs},
        )

    return build


for _name in ("digits", "mnist", "emnist"):
    register_builder(_name)(_pool_builder(_name))
