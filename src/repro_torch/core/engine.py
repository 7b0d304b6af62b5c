"""The FedAR round engine (Algorithm 2), resident on one device or sharded
over a client mesh.

Each communication round runs, in order: CheckResource and trust-sorted
selection, ClientUpdate (E epochs of local SGD for every client of the
fleet; non-participants are masked out of the aggregate), virtual latency
and the straggler mask, uplink compression with error feedback, the
always-on non-finite quarantine, the deviation ban, the defense weights,
aggregation (``fedar``, ``fedavg``, buffered ``async`` or the legacy
``async_seq`` fold), and the Algorithm 1 trust and battery updates.
Where the reference scans rounds inside one XLA program, ``run`` is a
Python loop over ``step``.

Carried state (``EngineState``) -> Algorithm 2 of the paper:

  ``params``      global model w_i, one flat (D,) float32 vector (a
                  nested param tree crosses through ``flatten`` /
                  ``unflatten`` in the reference's stacked-tree order;
                  each leaf keeps its dtype in the tree)
  ``trust``       trust scores C_m + the participation / failure counters
  ``resources``   per-robot (M, B, E, F); battery drains with participation
  ``fg_history``  defense history block (N, d): d = D for dense FoolsGold,
                  the sketch width r for ``foolsgold_sketch``, 0 without
  ``pending_*``   the buffered-async slot of each client: the in-flight
                  (decoded) delta (N, D), its weight, issue and arrival
                  rounds and a valid bit; the delta block is (N, 0)
                  unless ``aggregation="async"``
  ``compress_residual``  error-feedback residual (N, D), (N, 0) with
                  ``compress="none"``
  ``round_idx``   the round counter i

Per-round outputs (``RoundOutputs``): post-update trust, the selected and
on-time masks, virtual round time, and eval loss/accuracy.

Padding-free, selection-gated hot path: ``data["packed"]`` (built by
``FederatedDataset.packed_arrays``, or picked per fleet by
``prepare_data``) swaps the rectangular sample slab for size buckets, and
``FedConfig.select_frac`` gates local SGD down to a statically capped
cohort (unselected clients contribute exact zeros).  ``device_data`` turns
the packed dict into a ``PackedLayout`` once per ``step`` / ``run`` call:
the buckets become one batch-tile buffer that the ragged local-SGD kernel
walks, each client reading its own tiles, and every round-invariant table
(tile addresses, the descending-width row order, the gated slot plan) is
built there.  A drift schedule ``round_mask`` (W, N, n) trains round t on
window ``t mod W``, on the dense and on the packed layout.

Fault injection (``FedConfig.faults``, ``core/faults.py``) adds crashed,
corrupted and unavailable clients to the round.  ``CohortEngine`` drives
the same round at a cohort of K clients sampled each round from a host-side
``ClientStore`` of the whole fleet, for fleets larger than the card holds.

The kernels of the round run on the card through the routing knobs
``FedConfig.sgd_impl`` (local SGD), ``agg_impl`` (aggregation),
``defense_impl`` (the similarity block) and ``compress_impl`` (the uplink
codecs); see ``kernels/ops.resolve_impl``.
The engine runs on ``cuda`` unless the caller passes ``device="cpu"``, and
raises when there is no CUDA device: it never falls back to the CPU.

Client mesh (``FedConfig.mesh_shape`` = k > 1, ``core/distributed.py``):
each of k processes (``distributed.spawn``) runs this round on its block of
N / k clients, on its own card (``cuda:rank``, NCCL) or on the CPU (gloo).
The rank's block of the data, the defense history, the async delta buffer
and the residual live on its device; the (N,) bookkeeping is replicated,
and the round's cross-client reductions go through ``self.comms`` at the
reference's sites.  A rank trains its own clients only; with
``select_frac`` each rank caps its cohort at C slots (not C / k: the
selection may land wholly on one rank's clients).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.common.config import FedConfig
from repro_torch.configs.fedar_mnist import MnistConfig
from repro_torch.convert import GeneratorDraws
from repro_torch.core import aggregation as agg
from repro_torch.core.client_store import ClientStore
from repro_torch.core.compress import make_compression, make_residual
from repro_torch.core.defense import make_defense
from repro_torch.core.distributed import ClientComms, MeshComms, client_mesh
from repro_torch.core.faults import make_faults
from repro_torch.core.resources import (
    ResourceState,
    TaskRequirement,
    drain_battery,
    make_fleet,
    round_latency,
)
from repro_torch.core.selection import sample_cohort, select_clients
from repro_torch.core.trust import TrustState, init_trust, update_trust
from repro_torch.data.datasets import FederatedDataset
from repro_torch.kernels.ops import resolve_impl
from repro_torch.models.client import ClientModel
from repro_torch.models.mnist import MnistClientModel


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without a CUDA device that raises: the CPU
    is used only when the caller asks for it.  On the card, float32 matrix
    products and convolutions are kept out of TF32."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                'device="cpu" to run on the CPU'
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def median_arrival_timeout(fed: FedConfig, *, train_flops: float, model_bytes: float,
                           rounds: int, device="cpu") -> float:
    """A round timeout worked out from the fleet's own latencies, for
    models whose virtual round dwarfs a fixed timeout (an LM at full
    width): the latency model (``round_latency`` over ``make_fleet``'s
    resources and the default draws' jitter, as the engine computes it)
    for rounds 0 to ``rounds`` - 1, and of each round the honest
    (non-poisoner) clients' median latency; the largest of those medians,
    plus 1%.  At least half of the honest robots then arrive in time
    every round, and the rest straggle."""
    n = fed.num_clients
    res, poison = make_fleet(n, num_starved=fed.num_starved,
                             num_poisoners=fed.num_poisoners, seed=fed.seed,
                             device=device)
    draws = GeneratorDraws(fed.seed, device)
    lat = torch.stack([round_latency(res, train_flops=train_flops, model_bytes=model_bytes,
                                     factor=draws.latency_factor(r, n))
                       for r in range(rounds)]).cpu()
    honest = torch.as_tensor(~poison)
    return 1.01 * float(lat[:, honest].median(dim=1).values.max())


def ordered_leaves(tree, path=()) -> list:
    """The leaves of a param tree as (path, tensor) pairs in the flat
    order: dict keys sorted at every level (``jax.tree.leaves``' order),
    and a list of per-layer dicts (the LM's ``layers``) leaf by leaf, each
    leaf over every layer in turn, as the reference's tree stacks it on a
    leading layer axis."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in ordered_leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        per = [ordered_leaves(t, path + (i,)) for i, t in enumerate(tree)]
        if len({len(p) for p in per}) > 1:
            raise ValueError(f"the entries of the list at {path} differ in structure")
        return [p[j] for j in range(len(per[0]) if per else 0) for p in per]
    return [(path, tree)]


def flatten(params, rows: bool = False) -> torch.Tensor:
    """Param tree -> flat (D,) aggregation-boundary vector in
    ``ordered_leaves`` order (``b1, b2, w1, w2`` for the MLP); mixed leaf dtypes promote to
    the widest float (fp32 for the LM's bf16 weights and fp32 norms).
    ``rows=True`` flattens a tree of stacked (R, ...) leaves to (R, D)."""
    leaves = [leaf for _, leaf in ordered_leaves(params)]
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in leaves))
    if rows:
        return torch.cat([t.reshape(t.shape[0], -1).to(dtype) for t in leaves], 1)
    return torch.cat([t.reshape(-1).to(dtype) for t in leaves])


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None


def with_leaves(template, leaves):
    """A tree shaped like ``template`` holding ``leaves``, given in the
    flat order (``ordered_leaves``)."""
    out = _skeleton(template)
    for (path, _), leaf in zip(ordered_leaves(template), leaves, strict=True):
        node = out
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
    return out


def unflatten(flat, template):
    """Flat (D,) vector -> a tree shaped like ``template``, each leaf cast
    to the template leaf's dtype (bf16 round-trips exactly through the
    fp32 flat view)."""
    leaves, off = [], 0
    for _, leaf in ordered_leaves(template):
        n = leaf.numel()
        leaves.append(flat[off:off + n].reshape(leaf.shape).to(leaf.dtype))
        off += n
    return with_leaves(template, leaves)


class EngineState(NamedTuple):
    """Every piece of server state Algorithm 2 mutates."""

    params: torch.Tensor  # (D,) flat global model
    trust: TrustState  # (N,) score / participations / failures
    resources: ResourceState  # (N,) memory / bandwidth / battery / compute
    fg_history: torch.Tensor  # (N, d) defense history
    pending_delta: torch.Tensor  # (N, D) async in-flight deltas, else (N, 0)
    pending_weight: torch.Tensor  # (N,) float32 aggregation weight
    pending_issued: torch.Tensor  # (N,) int32 round the update was made
    pending_arrival: torch.Tensor  # (N,) int32 round it reaches the server
    pending_valid: torch.Tensor  # (N,) bool slot holds an undelivered update
    compress_residual: torch.Tensor  # (N, D) error feedback, else (N, 0)
    round_idx: int  # communication round i


class RoundOutputs(NamedTuple):
    """One round's history row (stacked over rounds by ``run``)."""

    trust: torch.Tensor  # (N,) post-update trust scores
    selected: torch.Tensor  # (N,) bool participant mask M_m
    on_time: torch.Tensor  # (N,) bool arrived within timeout t
    round_time: torch.Tensor  # () virtual seconds this round cost
    loss: torch.Tensor  # () eval loss (nan when no eval set)
    acc: torch.Tensor  # () eval accuracy (nan when no eval set)


class PackedLayout(NamedTuple):
    """The packed data on the device, with everything a round reuses.

    The buckets live in one batch-tile buffer: bucket b (rows_b clients of
    width L_b) pads each row to nb_b = ceil(L_b / B) whole batches with
    mask-False samples and lays its rows' tiles end to end.  Per packed row
    (the bucket concatenation order ``inv`` refers to): the activation id,
    the batch count ``nb``, the first tile ``off``, the canonical client
    ``perm`` and the real-row bit ``valid``."""

    tiles: dict  # "x" (T, B, I) float32, "y" (T, B) int32
    tile_mask: torch.Tensor  # (T, B) bool static validity
    tile_round_mask: Optional[torch.Tensor]  # (W, T, B) bool drift windows
    act: torch.Tensor  # (R,) int32
    nb: torch.Tensor  # (R,) int32 batches per row
    off: torch.Tensor  # (R,) int32 first tile per row
    perm: torch.Tensor  # (R,) int64 canonical client per row
    valid: torch.Tensor  # (R,) bool
    inv: torch.Tensor  # (N,) int64 canonical client -> packed row
    buckets: tuple  # ((first tile, rows, nb), ...) in packed order
    desc_rows: torch.Tensor  # (R,) int64 packed rows, widest bucket first
    desc_buckets: tuple  # ((nb, rows), ...) widest bucket first
    plan: tuple  # this engine's gated slot plan ((slot nb, slots), ...)
    n_max: int  # the dense rectangle width (latency model)


class DeviceData(dict):
    """A data dict that ``FedAREngine.device_data`` made: tensors on the
    engine's device, each client-indexed entry holding the clients of
    mesh block ``block`` = (rank, shards) only.  An engine of the same
    block takes it back as it is."""

    def __init__(self, entries, block: tuple):
        super().__init__(entries)
        self.block = block


def _to_device(tree, device):
    """A param tree (dicts, lists, arrays or tensors) on ``device``, every
    leaf in its own dtype."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return torch.as_tensor(tree, device=device)


class FedAREngine:
    """FedAR round engine over a simulated robot fleet.

    ``step`` runs one communication round, ``run`` R rounds.  ``draws`` is
    the draw provider (``convert.GeneratorDraws`` by default, seeded by
    ``FedConfig.seed``); ``init_params`` optionally replaces the model's
    own init (e.g. ``convert.params_from_jax`` of the reference's).

    Under a fault schedule, ``fault_masks`` holds the last round's (N,)
    masks of crashed, corrupted, unavailable and quarantined clients, on
    the device (``None`` with ``faults="none"``), for fault reports.

    ``mesh`` is the ``distributed.ClientMesh`` the engine runs on (``None``
    on one device) and ``comms`` its collectives; under a mesh the device
    is the mesh's (``device`` must name the same kind: the cards for NCCL,
    the CPU for gloo), and the state's (N, ...) blocks are this rank's
    (N / k, ...) rows."""

    def __init__(
        self,
        model: Union[ClientModel, MnistConfig],
        fed: FedConfig,
        req: TaskRequirement,
        *,
        lr: float = 0.1,
        device=None,
        draws=None,
        init_params=None,
    ):
        if fed.aggregation not in ("fedar", "fedavg", "async", "async_seq"):
            raise ValueError(f"unknown aggregation {fed.aggregation!r}")
        if isinstance(model, MnistConfig):
            model = MnistClientModel(model)
        self.mesh = client_mesh(fed)
        self.device = resolve_device(device)
        self.comms = ClientComms()
        if self.mesh is not None:
            if self.device.type != self.mesh.device.type:
                raise ValueError(
                    f"the engine was asked for {self.device} but its mesh's "
                    f"{self.mesh.backend} process group runs on "
                    f"{self.mesh.device}: NCCL ranks on the cards, gloo on the CPU"
                )
            self.device = resolve_device(self.mesh.device)
            self.comms = MeshComms(self.mesh.group, self.mesh.rank,
                                   self.mesh.size, tree=fed.tree_reduce,
                                   axis=fed.client_axis)
        self.n_local = fed.num_clients // self.comms.shards
        self.model = model
        self.fed, self.req, self.lr = fed, req, lr
        # a family without a fused kernel has one ClientUpdate, its plain
        # client_update, which "auto" names; asking for the kernel raises
        if fed.sgd_impl == "kernel" and not model.supports_fused:
            raise ValueError(
                f'sgd_impl="kernel" asks for the fused local-SGD kernel, but '
                f"model family {model.family!r} has none"
            )
        self.sgd_route = resolve_impl(fed.sgd_impl, "sgd", self.device)
        if not model.supports_fused:
            self.sgd_route = "einsum"
        elif self.sgd_route == "kernel":
            model.check_fused(fed.local_batch_size)
        resolve_impl(fed.agg_impl, "agg", self.device)
        resolve_impl(fed.defense_impl, "defense", self.device)
        resolve_impl(fed.compress_impl, "compress", self.device)
        if init_params is None:
            gen = torch.Generator().manual_seed(fed.seed)
            self.template = model.init(gen, self.device)
        else:
            # each leaf keeps its dtype (the LM's bf16 weights, fp32 norms)
            self.template = _to_device(init_params, self.device)
            model.adopt_template(self.template)
        self.dim = sum(leaf.numel() for _, leaf in ordered_leaves(self.template))
        self.defense = make_defense(fed, self.dim, self.device)
        self.compression = make_compression(fed, self.dim)
        self.faults = make_faults(fed, self.device)
        self.fault_masks = None
        self._client_ids = torch.arange(fed.num_clients, device=self.device)
        self._local_ids = self.comms.local(self._client_ids)
        self.resources0, self.poison_mask = make_fleet(
            fed.num_clients,
            num_starved=fed.num_starved,
            num_poisoners=fed.num_poisoners,
            seed=fed.seed,
            device=self.device,
        )
        self.draws = draws if draws is not None else GeneratorDraws(fed.seed, self.device)
        # selection-gated local SGD: static cohort cap C = ceil(frac * N),
        # which must cover the selection count k
        self.cohort_cap = None
        if fed.select_frac is not None:
            if not 0.0 < fed.select_frac <= 1.0:
                raise ValueError(
                    f"select_frac must be in (0, 1], got {fed.select_frac}"
                )
            self.cohort_cap = max(
                1, int(np.ceil(fed.select_frac * fed.num_clients))
            )
            k = max(1, int(fed.num_clients * fed.client_fraction))
            if self.cohort_cap < k:
                raise ValueError(
                    f"select_frac={fed.select_frac} caps the SGD cohort at "
                    f"C={self.cohort_cap} < the {k} clients selection can "
                    f"pick (client_fraction={fed.client_fraction}); raise "
                    f"select_frac to at least client_fraction"
                )

    # ------------------------------------------------------------------
    def init_state(self) -> EngineState:
        N, D, dev = self.fed.num_clients, self.dim, self.device
        n_loc = self.n_local
        buf_d = D if self.fed.aggregation == "async" else 0
        return EngineState(
            params=flatten(self.template),
            trust=init_trust(N, self.fed, dev),
            resources=self.resources0,
            fg_history=torch.zeros((n_loc, self.defense.history_dim(D)), device=dev),
            pending_delta=torch.zeros((n_loc, buf_d), device=dev),
            pending_weight=torch.zeros((N,), device=dev),
            pending_issued=torch.zeros((N,), dtype=torch.int32, device=dev),
            pending_arrival=torch.zeros((N,), dtype=torch.int32, device=dev),
            pending_valid=torch.zeros((N,), dtype=torch.bool, device=dev),
            compress_residual=make_residual(
                n_loc, self.compression.residual_dim(D), dev),
            round_idx=0,
        )

    # (N,) entries of a data dict that every rank holds whole
    _REPLICATED = ("sizes", "cohort_valid")

    def _local_block(self, key: str, v, local: bool):
        """This rank's block of a client-indexed data entry (axis 1 of the
        drift ``round_mask``, axis 0 of the rest): sliced out of the whole
        fleet's, or, with ``local``, the entry as it is, which must hold
        the rank's N / k clients."""
        axis = 1 if key == "round_mask" else 0
        n = v.shape[axis]
        want = self.n_local if local else self.fed.num_clients
        if n != want:
            raise ValueError(
                f"data[{key!r}] has {n} clients on axis {axis}; the engine "
                f"takes {'this rank' if local else 'the fleet'}'s {want} "
                f"({self.fed.num_clients} clients over {self.comms.shards} "
                f"shard(s))")
        if local:
            return v
        blk = slice(self.comms.rank * self.n_local, (self.comms.rank + 1) * self.n_local)
        return v[blk] if axis == 0 else v[:, blk]

    def device_data(self, data, *, local: bool = False) -> DeviceData:
        """The round's data dict as tensors on the engine's device, in the
        dtypes the kernels take (x float32, y / activations int32, sizes
        float32, masks bool); numpy arrays are copied over once.  Each
        client-indexed entry holds the whole fleet, of which only this
        rank's block is moved on a mesh, or, with ``local=True``, this
        rank's block already; ``sizes`` and ``cohort_valid`` stay whole.
        A ``DeviceData`` this engine's block made is taken as local.  A
        packed dict (``data["packed"]``) becomes a ``PackedLayout`` of the
        rank's rows; one that already is passes through."""
        block = (self.comms.rank, self.comms.shards)
        local = local or getattr(data, "block", None) == block
        dtypes = {"x": torch.float32, "y": torch.int32,
                  "activations": torch.int32, "sizes": torch.float32,
                  "mask": torch.bool, "round_mask": torch.bool,
                  "cohort_valid": torch.bool, "tokens": torch.int64,
                  "labels": torch.int64}
        out = {}
        for k, v in data.items():
            if k == "packed":
                lay = v if isinstance(v, PackedLayout) else self._pack(v)
                if lay.tiles["x"].shape[1] != self.fed.local_batch_size:
                    raise ValueError(
                        f"packed layout tiled for batch size "
                        f"{lay.tiles['x'].shape[1]}, the engine trains with "
                        f"{self.fed.local_batch_size}"
                    )
                # the slot plan depends on this engine's cohort cap
                out[k] = lay._replace(
                    plan=self._packed_cohort_plan(lay.desc_buckets))
                continue
            if k not in self._REPLICATED:
                v = self._local_block(k, v, local)
            t = torch.as_tensor(v, device=self.device)
            out[k] = t.to(dtypes[k]).contiguous() if k in dtypes else t
        return DeviceData(out, block)

    def _check_packed(self, packed) -> None:
        """A packed dict is built for one shard count (its ``perm`` is
        shard-local): the engine's, ``comms.shards``.  Only
        ``packed_supported`` families take it."""
        if not self.model.packed_supported:
            raise ValueError(
                f"model family {self.model.family!r} does not support the "
                f"bucketed packed layout; pass the dense per-client arrays "
                f"(FederatedDataset.arrays()) instead"
            )
        built = int(np.asarray(packed["shards"]))
        if built != self.comms.shards:
            raise ValueError(
                f"packed data was built for {built} shard(s) "
                f"(FederatedDataset.packed_arrays(shards=...)) but the "
                f"engine runs {self.comms.shards}; rebuild the packed "
                f"layout with shards={self.comms.shards}"
            )

    def _local_packed(self, packed) -> dict:
        """This rank's rows of a packed dict: the buckets are laid out
        shard-major with equal row counts a shard, so rank r's rows of
        bucket b are its r-th block; ``perm`` is already shard-local and
        ``inv`` is cut to the rank's clients."""
        k, r = self.comms.shards, self.comms.rank
        if k == 1:
            return packed

        def rows(a, axis=0):
            a = np.asarray(a)
            n = a.shape[axis] // k
            return a[r * n:(r + 1) * n] if axis == 0 else a[:, r * n:(r + 1) * n]

        out = dict(packed)
        for key in ("x", "y", "mask", "perm", "valid", "act"):
            out[key] = tuple(rows(b) for b in packed[key])
        if "round_mask" in packed:
            out["round_mask"] = tuple(rows(b, 1) for b in packed["round_mask"])
        out["inv"] = rows(packed["inv"])
        return out

    def _pack(self, packed) -> PackedLayout:
        """Move a ``packed_arrays`` dict to the device as one batch-tile
        buffer plus the round-invariant row tables (``PackedLayout``)."""
        self._check_packed(packed)
        packed = self._local_packed(packed)
        dev, B = self.device, self.fed.local_batch_size
        xs = [np.asarray(x) for x in packed["x"]]
        rows = [x.shape[0] for x in xs]
        widths = [x.shape[1] for x in xs]
        nbs = [-(-w // B) for w in widths]
        starts = np.cumsum([0] + [r * n for r, n in zip(rows, nbs)])
        T, I = int(starts[-1]), xs[0].shape[2]
        rms = packed.get("round_mask")
        xt = torch.zeros((T, B, I), dtype=torch.float32, device=dev)
        yt = torch.zeros((T, B), dtype=torch.int32, device=dev)
        mt = torch.zeros((T, B), dtype=torch.bool, device=dev)
        rmt = (None if rms is None else torch.zeros(
            (rms[0].shape[0], T, B), dtype=torch.bool, device=dev))
        for b, (r, w, n) in enumerate(zip(rows, widths, nbs)):
            s, e = int(starts[b]), int(starts[b + 1])
            xt[s:e].view(r, n * B, I)[:, :w] = torch.as_tensor(xs[b])
            yt[s:e].view(r, n * B)[:, :w] = torch.as_tensor(
                np.asarray(packed["y"][b], np.int32))
            mt[s:e].view(r, n * B)[:, :w] = torch.as_tensor(
                np.asarray(packed["mask"][b], bool))
            if rmt is not None:
                rmt[:, s:e].view(-1, r, n * B)[:, :, :w] = torch.as_tensor(
                    np.asarray(rms[b], bool))

        def cat(key, dtype):
            return torch.as_tensor(np.concatenate(
                [np.asarray(v) for v in packed[key]]).astype(dtype), device=dev)

        nb = np.repeat(nbs, rows).astype(np.int32)
        off = np.concatenate([s + n * np.arange(r) for s, r, n
                              in zip(starts[:-1], rows, nbs)]).astype(np.int32)
        # the gated cohort walks rows widest bucket first
        desc = sorted(range(len(xs)), key=lambda b: -widths[b])
        row0 = np.cumsum([0] + rows)
        desc_rows = np.concatenate([np.arange(row0[b], row0[b + 1]) for b in desc])
        return PackedLayout(
            tiles={"x": xt, "y": yt}, tile_mask=mt, tile_round_mask=rmt,
            act=cat("act", np.int32),
            nb=torch.as_tensor(nb, device=dev),
            off=torch.as_tensor(off, device=dev),
            perm=cat("perm", np.int64), valid=cat("valid", bool),
            inv=torch.as_tensor(np.asarray(packed["inv"], np.int64), device=dev),
            buckets=tuple((int(s), r, n) for s, r, n in zip(starts[:-1], rows, nbs)),
            desc_rows=torch.as_tensor(desc_rows, device=dev),
            desc_buckets=tuple((nbs[b], rows[b]) for b in desc), plan=(),
            n_max=int(np.asarray(packed["n_max"])),
        )

    def prepare_data(self, ds: FederatedDataset, layout: str = "auto") -> dict:
        """This engine's data dict from a ``FederatedDataset``, on the
        device: dense or packed picked per fleet (``layout="auto"``, the
        ``scenarios.pick_layout`` estimate with the local batch size as the
        width quantum), or forced with ``"dense"`` / ``"packed"``."""
        if ds.num_clients != self.fed.num_clients:
            raise ValueError(
                f"dataset has {ds.num_clients} clients but FedConfig.num_"
                f"clients={self.fed.num_clients}; build the config from the "
                f"fleet's client count"
            )
        return self.device_data(ds.engine_arrays(
            shards=self.comms.shards, quantum=self.fed.local_batch_size,
            layout=layout))

    def _eval_set(self, eval_set):
        """An (x, y) pair for the MLP, or a dict of fields (the LM's
        ``tokens`` / ``labels``), on the engine's device."""
        if eval_set is None:
            return None
        if isinstance(eval_set, dict):
            return {k: torch.as_tensor(v, device=self.device).long()
                    for k, v in eval_set.items()}
        x, y = eval_set
        return (torch.as_tensor(x, dtype=torch.float32, device=self.device),
                torch.as_tensor(y, dtype=torch.int64, device=self.device))

    # ---------------------------------------------------- ClientUpdate
    def _block_sgd(self, g_flat, fields, m):
        """Local SGD over the client block -> stacked (rows, D) flat local
        params.  The kernel route launches the model's fused local-SGD
        kernel once for the whole block; the plain route runs the model's
        ``client_update`` (the dense path floors the batch count, R5 in
        ROADMAP.md)."""
        fed = self.fed
        if self.sgd_route == "kernel":
            return self.model.fused_block_update(
                g_flat, fields, m, lr=self.lr,
                batch_size=fed.local_batch_size, epochs=fed.local_epochs,
            )
        new = self.model.client_update(
            unflatten(g_flat, self.template), fields, lr=self.lr,
            batch_size=fed.local_batch_size, epochs=fed.local_epochs,
            sample_mask=m,
        )
        # the LM writes its flat rows itself (no stacked copy beside them)
        return new if isinstance(new, torch.Tensor) else flatten(new, rows=True)

    def _gated_block_locals(self, g_flat, fields, m, sel_rows):
        """Selection-gated ClientUpdate on the dense layout: local SGD over
        the (statically capped) selected rows of this rank's block only
        (``sel_rows`` is the local selection).  Returns ``(idx,
        locals_c, valid)``: the client each cohort slot came from, the
        cohort's post-SGD rows, and which slots hold a selected client."""
        cap = min(sel_rows.shape[0], self.cohort_cap)
        # stable: selected rows first, in client order (ROADMAP trap 1)
        order = torch.argsort((~sel_rows).to(torch.int32), stable=True)
        idx = order[:cap]
        m_c = None if m is None else m[idx]
        locals_c = self._block_sgd(g_flat, {k: v[idx] for k, v in fields.items()},
                                   m_c)
        return idx, locals_c, sel_rows[idx]

    @staticmethod
    def _expand_cohort(vals, canon, valid, rows: int, fill_row):
        """(C, D) cohort rows -> (rows, D) in client order: one int scatter
        builds the client -> slot map (invalid slots drop into a spare
        entry, clients outside the cohort point at the appended
        ``fill_row``), then one row gather."""
        cap = vals.shape[0]
        aug = torch.cat([vals, fill_row[None, :]])
        inv = torch.full((rows + 1,), cap, dtype=torch.int64, device=vals.device)
        inv[torch.where(valid, canon, rows)] = torch.arange(cap, device=vals.device)
        return aug[inv[:rows]]

    def _ragged_block_sgd(self, g_flat, lay: PackedLayout, rows, tile_mask,
                          blocks):
        """Local SGD of packed rows -> (R, D) post-SGD rows in ``rows``
        order.  ``rows`` is None (every packed row) or an index tensor into
        the layout's row tables.  The kernel route launches the model's
        ragged kernel once over the layout's tile buffer, each row reading
        its own tiles; the plain route runs ``_block_sgd`` over each
        rectangular block of ``blocks()``, a generator of (fields, mask)."""
        if self.sgd_route == "kernel":
            row_tables = (lay.act, lay.nb, lay.off)
            if rows is not None:
                row_tables = tuple(t[rows] for t in row_tables)
            return self.model.fused_ragged_update(
                g_flat, lay.tiles, tile_mask, row_tables, lr=self.lr,
                epochs=self.fed.local_epochs,
            )
        return torch.cat([self._block_sgd(g_flat, f, m) for f, m in blocks()])

    def _packed_cohort_plan(self, desc_buckets) -> tuple:
        """Static slot plan of the gated cohort over the buckets, given
        widest first as ((nb, rows), ...): ONE allocation of ``min(C, sum
        rows)`` slots, widest bucket first, as ((slot batch count, slots),
        ...).  At most C clients are selected and slots are granted widest
        first, so the j-th widest selected row lands on a slot at least as
        wide as its own bucket."""
        if self.cohort_cap is None:
            return ()
        plan, remaining = [], self.cohort_cap
        for nb, r in desc_buckets:
            take = min(r, remaining)
            if take > 0:
                plan.append((nb, take))
                remaining -= take
        return tuple(plan)

    @staticmethod
    def _packed_round_mask(lay: PackedLayout, round_idx: int):
        """This round's (T, B) tile validity: the static mask & the drift
        schedule's active window."""
        if lay.tile_round_mask is None:
            return lay.tile_mask
        rm = lay.tile_round_mask
        return lay.tile_mask & rm[round_idx % rm.shape[0]]

    def _packed_fields(self, lay: PackedLayout, x, y, rows):
        return dict(zip(self.model.data_keys, (x, y, lay.act[rows])))

    def _packed_gated_locals(self, g_flat, lay: PackedLayout, sel_loc,
                             tile_mask):
        """Selection-gated ClientUpdate over the packed layout.  One stable
        argsort over every packed row, widest bucket first, keyed selected
        first; the first ``min(C, rows)`` entries are the cohort's slots.
        The kernel route trains each slot's row on its own tiles of the
        invariant tile buffer (no per-round sample gather); the plain route
        gathers each plan group's rows into slot-wide blocks, as the
        reference does (a narrower row in a wider slot runs extra
        all-masked batches, exact no-ops).  Returns ``(locals_c, cohort)``,
        cohort = (client of each slot, slot holds a selected client)."""
        B = self.fed.local_batch_size
        desc = lay.desc_rows
        sel_d = sel_loc[lay.perm[desc]] & lay.valid[desc]
        order = torch.argsort((~sel_d).to(torch.int32), stable=True)
        slots = order[:sum(take for _, take in lay.plan)]
        rows = desc[slots]

        def blocks():
            o = 0
            for nb_slot, take in lay.plan:
                r = rows[o:o + take]
                o += take
                j = torch.arange(nb_slot, device=r.device)
                own = lay.nb[r].to(torch.int64)[:, None]
                tiles = lay.off[r].to(torch.int64)[:, None] + torch.minimum(j, own - 1)
                m = tile_mask[tiles] & (j < own)[..., None]
                x = lay.tiles["x"][tiles].reshape(take, nb_slot * B, -1)
                y = lay.tiles["y"][tiles].reshape(take, nb_slot * B)
                yield (self._packed_fields(lay, x, y, r),
                       m.reshape(take, nb_slot * B))

        locals_c = self._ragged_block_sgd(g_flat, lay, rows, tile_mask, blocks)
        return locals_c, (lay.perm[rows], sel_d[slots])

    def _packed_locals(self, g_flat, lay: PackedLayout, sel_loc, round_idx):
        """ClientUpdate over the bucketed packed layout of this rank's
        clients (``sel_loc`` their selection) -> ``(locals_flat, locals_c,
        cohort)``: the (N_loc, D) post-SGD rows in client order, and in
        gated mode the compact cohort rows with their ``(canon, valid)``
        map, so that deviation and aggregation skip the known-zero rows
        (``None, None`` ungated).  Ungated, every packed row trains and one
        gather through ``inv`` restores client order; gated, unselected
        clients take the untouched global row (delta exactly zero)."""
        B = self.fed.local_batch_size
        tile_mask = self._packed_round_mask(lay, round_idx)
        if self.cohort_cap is None:
            def blocks():
                r0 = 0
                for s, r, nb in lay.buckets:
                    e = s + r * nb
                    x = lay.tiles["x"][s:e].view(r, nb * B, -1)
                    y = lay.tiles["y"][s:e].view(r, nb * B)
                    rows = torch.arange(r0, r0 + r, device=x.device)
                    r0 += r
                    yield (self._packed_fields(lay, x, y, rows),
                           tile_mask[s:e].reshape(r, nb * B))

            locals_cat = self._ragged_block_sgd(g_flat, lay, None, tile_mask,
                                                blocks)
            return locals_cat[lay.inv], None, None
        locals_c, cohort = self._packed_gated_locals(g_flat, lay, sel_loc,
                                                     tile_mask)
        locals_flat = self._expand_cohort(locals_c, cohort[0], cohort[1],
                                          sel_loc.shape[0], g_flat)
        return locals_flat, locals_c, cohort

    # ------------------------------------------------------------------
    def _round_step(self, state: EngineState, data, eval_set, force_straggler,
                    train_flops: float):
        """One communication round.  ``data``: the model's stacked
        per-client tensors (``x`` (N, n, 784), ``y`` (N, n), ``activations``
        (N,)), ``sizes`` (N,), and optionally ``mask`` (N, n) bool marking
        the real samples of ragged shards, and ``cohort_valid`` (N,) bool,
        the cohort engine's host-side selection.  On a mesh the client
        entries, ``state.fg_history``, ``pending_delta`` and
        ``compress_residual`` hold this rank's block; every (N,) vector is
        replicated, and cross-client reductions go through ``comms``."""
        fed, comms = self.fed, self.comms
        N = fed.num_clients
        r = state.round_idx

        # --- fault injection: this round's realization; faults="none" takes
        # no draw at all
        fdraw = None
        if self.faults.active:
            fdraw = self.faults.draw(self.draws.fault_coins(r, N),
                                     self._client_ids, r)

        # --- Algorithm 2 lines 6-10: CheckResource + trust sort + sample.
        # In cohort mode the host already selected (``sample_cohort``): every
        # valid slot is a participant and no Gumbel draw is taken.
        if "cohort_valid" in data:
            selected = ok = data["cohort_valid"]
            if fdraw is not None:
                # flapping / battery-dead clients fail CheckResource even
                # though the host sampled them before the fault draw
                selected = ok = selected & ~fdraw.unavailable
        else:
            res_sel = state.resources
            if fdraw is not None:
                # an offline window reads as a dead battery to CheckResource;
                # the persistent battery column is untouched
                res_sel = res_sel._replace(battery=torch.where(
                    fdraw.unavailable, 0.0, res_sel.battery))
            selected, ok = select_clients(
                self.draws.gumbel(r, N), state.trust, res_sel, self.req, fed
            )

        # --- lines 16-21 (ClientUpdate); non-participants are masked out
        # of the aggregate, or with select_frac not trained at all
        g_flat = state.params
        sel_loc = comms.local(selected)
        locals_c = cohort = None  # the compact gated-cohort view
        if "packed" in data:
            locals_flat, locals_c, cohort = self._packed_locals(
                g_flat, data["packed"], sel_loc, r)
        else:
            # ragged / drifting shards: this round's sample mask
            sample_mask = data.get("mask")
            if "round_mask" in data:
                rm = data["round_mask"]
                window = rm[r % rm.shape[0]]
                sample_mask = (window if sample_mask is None
                               else sample_mask & window)
            fields = {k: data[k] for k in self.model.data_keys}
            if self.cohort_cap is None:
                locals_flat = self._block_sgd(g_flat, fields, sample_mask)
            else:
                idx, locals_c, valid = self._gated_block_locals(
                    g_flat, fields, sample_mask, sel_loc)
                cohort = (idx, valid)
                locals_flat = self._expand_cohort(locals_c, idx, valid,
                                                  self.n_local, g_flat)
        if fed.aggregation == "async_seq":  # folds the local models below
            deltas = locals_flat - g_flat[None, :]
        else:  # nothing reads the local models again: (N_loc, D) in place
            deltas = locals_flat.sub_(g_flat[None, :])
        # deviation and the fedar / fedavg reduction only need the cohort
        # rows (the rest are exact zeros)
        delta_c = None if locals_c is None else locals_c - g_flat[None, :]
        crashed = None
        if fdraw is not None:
            # mid-round crash: the client trained (its battery burns below)
            # but its uplink never reaches the server
            crashed = selected & fdraw.crash
            # corruption and quarantine rewrite client-order rows, so the
            # compact gated view is dropped under an active schedule
            delta_c = cohort = None

        # --- virtual time: latency per client, straggler = late vs timeout
        lat = round_latency(
            state.resources, train_flops=train_flops,
            model_bytes=self.dim * 4.0,
            factor=self.draws.latency_factor(r, N),
        )
        if force_straggler is not None:
            lat = torch.where(force_straggler, fed.timeout * 3.0, lat)
        on_time = lat <= fed.timeout
        if crashed is not None:
            # a crashed client reads as a missed deadline, never an arrival
            on_time = on_time & ~crashed
        # the rows the server can ever receive this round
        uplinked = selected if crashed is None else selected & ~crashed
        # rows visible server-side: fedavg waits for stragglers and async
        # buffers them; fedar and async_seq skip on timeout
        if fed.aggregation in ("fedavg", "async"):
            seen = uplinked
        else:
            seen = uplinked & on_time

        # --- uplink compression: transmitting clients send the encoded
        # payload, and everything downstream (deviation, defense,
        # aggregation) consumes the DECODED rows.  Per-mode transmit window:
        # fedavg's stragglers transmit too; fedar's never upload; async
        # transmits when its slot can admit (lag 0 or a free slot), the
        # client-side-knowable superset of _buffered_async's admit gate.
        residual = state.compress_residual
        transmit_g = None
        if self.compression.active:
            if fed.aggregation == "fedavg":
                transmit_g = uplinked
            elif fed.aggregation == "async":
                lag0 = torch.floor(lat / fed.timeout).to(torch.int32) == 0
                transmit_g = uplinked & (lag0 | ~state.pending_valid)
            else:
                transmit_g = uplinked & on_time
            transmit = comms.local(transmit_g)
            # the compact view is a compute shortcut: after the decode the
            # canonical rows are what every later op must see
            delta_c = cohort = None
            # stochastic codes keyed on the canonical client id, so that a
            # rank draws the rows the one-device run draws for its clients
            unif = (self.draws.uniform(r, self._local_ids, self.dim)
                    if self.compression.needs_uniforms else None)
            deltas_raw = deltas
            deltas, residual, payload = self.compression.roundtrip(
                deltas, residual, transmit, unif
            )
            comms.record_uplink(payload)

        # --- corrupt uplinks: garbage replaces the row the server RECEIVES
        # (after the decode, before the quarantine)
        if fdraw is not None:
            corrupt = fdraw.corrupt & (transmit_g if self.compression.active
                                       else seen)
            deltas = torch.where(comms.local(corrupt)[:, None],
                                 comms.local(fdraw.fill)[:, None], deltas)

        # --- non-finite quarantine (always on): a NaN/Inf row, or one past
        # the magnitude cap, contributes exact zeros and is branded deviated
        row_ok = torch.isfinite(deltas)
        cap = fed.resolved_quarantine_cap
        if cap is not None:
            row_ok = row_ok & (deltas.abs() <= cap)
        q_loc = ~row_ok.all(dim=-1)
        del row_ok
        # in place: no other name holds this round's received rows
        deltas = deltas.masked_fill_(q_loc[:, None], 0.0)
        if cohort is not None:
            delta_c = torch.where(q_loc[cohort[0]][:, None], 0.0, delta_c)
        if self.compression.active:
            # dropped-uplink retry: a quarantined transmission consumed its
            # residual for nothing, so the full raw value (delta + pre-round
            # residual) goes back into the residual; a non-finite raw value
            # cannot be recovered and the pre-round residual stays
            v = deltas_raw + state.compress_residual
            v_el = torch.isfinite(v)
            if cap is not None:
                v_el = v_el & (v.abs() <= cap)
            v_ok = v_el.all(dim=-1)
            retry = q_loc & transmit
            residual = torch.where(
                retry[:, None],
                torch.where(v_ok[:, None], v, state.compress_residual),
                residual,
            )
        quarantined = comms.all_gather(q_loc)  # (N,) replicated
        if fdraw is not None:
            self.fault_masks = dict(crashed=crashed, corrupted=corrupt,
                                    unavailable=fdraw.unavailable,
                                    quarantined=quarantined)

        # --- line 11: deviation ban + defense weights; in async mode every
        # participant's update eventually lands, so all of them are screened
        active = uplinked if fed.aggregation == "async" else selected & on_time
        deviated = agg.deviation_mask(
            deltas if cohort is None else delta_c, active & ~quarantined,
            fed.deviation_gamma, comms=comms, cohort=cohort,
        )
        deviated = deviated | (seen & quarantined)
        contributing = active & ~deviated
        weights = data["sizes"]
        fg_history = self.defense.update_history(
            state.fg_history, deltas, contributing, comms=comms
        )
        fgw = self.defense.weights(fg_history, contributing, comms=comms)
        if fgw is not None:
            weights = weights * fgw

        # --- lines 13-14: aggregate
        pending = dict(
            delta=state.pending_delta, weight=state.pending_weight,
            issued=state.pending_issued, arrival=state.pending_arrival,
            valid=state.pending_valid,
        )
        round_time = torch.full((), fed.timeout, device=self.device)
        agg_rows = deltas if cohort is None else delta_c
        if fed.aggregation == "fedavg":
            g_new = agg.fedavg_aggregate(
                g_flat, agg_rows, weights, uplinked & ~deviated,
                impl=fed.agg_impl, comms=comms, cohort=cohort,
            )
            round_time = torch.where(uplinked, lat, 0.0).max()
        elif fed.aggregation == "async":
            g_new, pending = self._buffered_async(
                g_flat, deltas, weights, contributing, lat, pending, r
            )
        elif fed.aggregation == "async_seq":
            order = torch.argsort(
                torch.where(contributing, lat, torch.inf), stable=True
            )
            g_new = agg.async_aggregate(
                g_flat, locals_flat, weights, contributing, order, fed,
                comms=comms,
            )
        else:  # fedar (timeout skip)
            g_new = agg.fedavg_aggregate(
                g_flat, agg_rows, weights, contributing, impl=fed.agg_impl,
                comms=comms, cohort=cohort,
            )

        # --- line 15 + Algorithm 1: trust and battery evolution
        trust = update_trust(
            state.trust, fed, selected=selected, on_time=on_time,
            deviated=deviated, interested=ok,
        )
        resources = drain_battery(state.resources, selected)

        if eval_set is not None:
            loss, acc = self.model.metrics(unflatten(g_new, self.template), eval_set)
        else:
            loss = acc = torch.full((), torch.nan, device=self.device)

        new_state = EngineState(
            params=g_new, trust=trust, resources=resources,
            fg_history=fg_history,
            pending_delta=pending["delta"], pending_weight=pending["weight"],
            pending_issued=pending["issued"],
            pending_arrival=pending["arrival"], pending_valid=pending["valid"],
            compress_residual=residual, round_idx=r + 1,
        )
        outputs = RoundOutputs(
            trust=trust.score, selected=selected, on_time=on_time,
            round_time=round_time, loss=loss, acc=acc,
        )
        return new_state, outputs

    def _buffered_async(self, g_flat, deltas, weights, contributing, lat,
                        pending, round_idx: int):
        """FedBuff-style no-wait merge with one buffer slot per client.
        Updates admitted this round land at once when the client beat the
        timeout; a straggler's update waits in its slot and merges
        ``floor(lat / t)`` rounds later with a ``(1 + tau)^-0.5`` staleness
        discount (none with ``staleness_decay="const"``).  One masked
        weighted reduction per round.  The slot bookkeeping is (N,) and
        replicated; only the delta buffer is this rank's (N_loc, D)
        block."""
        fed = self.fed
        # rounds until the update reaches the server (0 = within timeout)
        lag = torch.floor(lat / fed.timeout).to(torch.int32)
        # admit into a free slot, or supersede an in-flight update with a
        # fresh on-time one: a straggler selected again must not clobber
        # its own upload still in transit, or it would never arrive
        admit = contributing & ((lag == 0) | ~pending["valid"])
        delta_buf = torch.where(self.comms.local(admit)[:, None], deltas,
                                pending["delta"])
        weight_buf = torch.where(admit, weights, pending["weight"])
        issued = torch.where(admit, round_idx, pending["issued"])
        arrival = torch.where(admit, round_idx + lag, pending["arrival"])
        valid = admit | pending["valid"]

        delivered = valid & (arrival <= round_idx)
        staleness = None
        if fed.staleness_decay != "const":
            staleness = torch.clamp(round_idx - issued, min=0).to(torch.float32)
        g_new = agg.fedavg_aggregate(
            g_flat, delta_buf, weight_buf, delivered, staleness=staleness,
            impl=fed.agg_impl, comms=self.comms,
        )
        return g_new, dict(
            delta=delta_buf, weight=weight_buf, issued=issued,
            arrival=arrival, valid=valid & ~delivered,
        )

    # ------------------------------------------------------------------
    def _train_flops(self, data) -> float:
        """Per-client FLOPs of the latency model, from the DENSE sample
        width (``n_max`` for the packed layout): the physical layout must
        not move straggler numerics."""
        if "packed" in data:
            lay = data["packed"]
            shape = (lay.n_max,) + tuple(lay.tiles["x"].shape[2:])
        else:
            shape = tuple(data[self.model.data_keys[0]].shape[1:])
        return float(self.model.train_flops(shape, epochs=self.fed.local_epochs))

    def _force(self, force_straggler):
        if force_straggler is None:
            return None
        return torch.as_tensor(force_straggler, dtype=torch.bool, device=self.device)

    def step(self, state, data, *, eval_set=None, force_straggler=None):
        """One communication round -> (state, RoundOutputs)."""
        data = self.device_data(data)
        with torch.no_grad():
            return self._round_step(
                state, data, self._eval_set(eval_set),
                self._force(force_straggler), self._train_flops(data),
            )

    def run(self, state, data, *, rounds: int, eval_set=None,
            force_straggler=None):
        """``rounds`` rounds -> (state, outputs stacked over rounds)."""
        data = self.device_data(data)
        eval_set = self._eval_set(eval_set)
        force = self._force(force_straggler)
        flops = self._train_flops(data)
        outs = []
        with torch.no_grad():
            for _ in range(rounds):
                state, out = self._round_step(state, data, eval_set, force, flops)
                outs.append(out)
        return state, RoundOutputs(*(torch.stack(f) for f in zip(*outs)))


class CohortEngine:
    """Host-store cohort engine: fleets larger than the card holds.

    The full fleet lives in a numpy ``ClientStore`` on the host, and each
    round

      1. ``selection.sample_cohort`` draws a static-shape cohort of
         K = ``FedConfig.cohort_size`` clients from the store (trust and
         CheckResource over the host columns, keyed ``(seed, round)``),
      2. the fleet object materializes only those K clients' samples
         (``cohort_arrays``) and the store gathers their rows (``gather``),
      3. a sub-``FedAREngine`` built at ``num_clients=K`` on this engine's
         device runs the unchanged round body, with ``cohort_valid`` as its
         selection and the store's absolute round as its round (its
         latency, QSGD and fault draws are taken at ``(seed, round)`` for K
         clients),
      4. the cohort's trust / battery / history (and residual, and async
         slot) rows go back (``scatter_round``) and ``finish_round`` evolves
         the rest of the fleet on the host.

    Device memory is O(K * D + K * samples), independent of N; the host
    holds O(N * smallstate), plus O(N * D) for the residual and the async
    buffer when those are on.  The fault schedule's traits follow the
    cohort SLOT, not the fleet client, as in the reference (ROADMAP Queue 3
    R9).  K >= N is not this class's job: ``FedARServer`` drops
    ``cohort_size`` and runs the resident engine.

    On a client mesh (``FedConfig.mesh_shape`` = k, K divisible by k) the
    sub-engine runs sharded: every rank keeps the same host store and
    samples the same cohort, moves only its K / k slots' samples and
    (K, ...) rows to its device (``sizes`` and ``cohort_valid`` whole),
    and after the round all-gathers the updated history, residual and
    pending rows, so that every rank scatters the same K rows and the
    stores stay identical.  The sub-engine aggregates with the two-level
    tree (``tree_reduce=True``).

    ``timings``: set it to a dict to record each part of ``run_round`` in
    wall seconds (lists keyed by part, ``PARTS``); the card is synchronized
    at every part boundary then, and never otherwise."""

    PARTS = ("sample_cohort", "cohort_arrays", "gather", "host_to_device",
             "device_round", "device_to_host", "scatter_round", "finish_round")

    def __init__(
        self,
        model: Union[ClientModel, MnistConfig],
        fed: FedConfig,
        req: TaskRequirement,
        *,
        lr: float = 0.1,
        device=None,
        draws=None,
        init_params=None,
    ):
        if fed.cohort_size is None:
            raise ValueError("CohortEngine needs FedConfig.cohort_size set")
        if fed.cohort_size >= fed.num_clients:
            raise ValueError(
                f"cohort_size={fed.cohort_size} >= num_clients="
                f"{fed.num_clients}: the whole fleet fits on device; use "
                f"the resident engine (FedARServer does this automatically)"
            )
        if fed.aggregation == "async_seq":
            raise ValueError(
                "aggregation='async_seq' folds every client's full local "
                "model sequentially per round (O(N) and no per-client "
                "buffer to persist), which a resampled cohort cannot "
                "replay; use aggregation='async': its pending-delta "
                "buffer lives in the client store and follows the cohort"
            )
        if fed.select_frac is not None:
            raise ValueError(
                "select_frac gating composes with the resident engine "
                "only; the cohort IS the statically-capped set: drop "
                "select_frac and lower cohort_size instead"
            )
        self.fed, self.req, self.lr = fed, req, lr
        # the device round is the resident round body at fleet size K; the
        # fleet's starved / poisoner layout is the store's, not the
        # sub-engine's
        sub = dataclasses.replace(
            fed, num_clients=fed.cohort_size, cohort_size=None,
            num_starved=0, num_poisoners=0, tree_reduce=True,
        )
        self.engine = FedAREngine(model, sub, req, lr=lr, device=device,
                                  draws=draws, init_params=init_params)
        if not self.engine.defense.cohort_compatible:
            raise ValueError(
                f"defense {self.engine.defense.name!r} is not cohort-"
                f"compatible: its per-client history is O(model_dim), so "
                f"the host store would be O(N*D); use 'foolsgold_sketch' "
                f"(O(N*r)) or 'none'"
            )
        self.device = self.engine.device
        self.mesh = self.engine.mesh
        self.comms = self.engine.comms
        self.model = self.engine.model
        self.template = self.engine.template
        self.dim = self.engine.dim
        self.compression = self.engine.compression
        self.faults = self.engine.faults
        self.store = ClientStore(
            fed, self.engine.defense.history_dim(self.dim),
            residual_dim=self.compression.residual_dim(self.dim),
            pending_dim=self.dim if fed.aggregation == "async" else 0,
        )
        self.poison_mask = self.store.poison_mask
        self.params = flatten(self.template)
        self._state0 = self.engine.init_state()
        self.timings = None

    @property
    def round_idx(self) -> int:
        return int(self.store.round_idx)

    def _mark(self, part: str, t0: float) -> float:
        """Record the part that ran since ``t0`` (when timing) and return
        the time the next part starts."""
        if self.timings is None:
            return t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings.setdefault(part, []).append(now - t0)
        return now

    def _device_state(self, rows, round_idx: int) -> EngineState:
        """The sub-engine's starting state from the cohort's store rows:
        the (K,) columns whole, the (K, d) blocks this rank's rows."""
        def dev(name):
            return torch.as_tensor(rows[name], device=self.device)

        def dev_block(name):
            return torch.as_tensor(self.comms.local(rows[name]), device=self.device)

        state = self._state0._replace(
            params=self.params,
            trust=TrustState(dev("score"), dev("participations"),
                             dev("failures")),
            resources=ResourceState(dev("memory"), dev("bandwidth"),
                                    dev("battery"), dev("compute")),
            fg_history=dev_block("history"),
            compress_residual=dev_block("residual"),
            round_idx=round_idx,
        )
        if self.store.pending_dim:
            # issue / arrival tags are absolute rounds, so an update whose
            # client sat out a few rounds lands (staleness-discounted) when
            # it rejoins
            state = state._replace(
                pending_delta=dev_block("pending_delta"),
                pending_weight=dev("pending_weight"),
                pending_issued=dev("pending_issued"),
                pending_arrival=dev("pending_arrival"),
                pending_valid=dev("pending_valid"),
            )
        return state

    def run_round(self, fleet, *, eval_set=None):
        """One store-sampled round -> (idx, valid, RoundOutputs).  ``idx`` /
        ``valid`` name the (K,) cohort; the outputs' client axis is the
        cohort's (row j belongs to fleet client ``idx[j]`` where
        ``valid[j]``)."""
        t = time.perf_counter()
        r = self.round_idx
        idx, valid, elig = sample_cohort(
            self.store.score, self.store.resources_view(), self.req, self.fed,
            cohort_size=self.fed.cohort_size, round_idx=r,
        )
        t = self._mark("sample_cohort", t)
        comms = self.comms
        arrays = fleet.cohort_arrays(comms.local(idx), comms.local(valid))
        if comms.shards > 1:  # the (K,) entries whole on every rank
            arrays["cohort_valid"] = valid
            arrays["sizes"] = comms.all_gather(torch.as_tensor(
                arrays["sizes"], dtype=torch.float32, device=self.device))
        data = self.engine.device_data(arrays, local=True)
        t = self._mark("cohort_arrays", t)
        rows = self.store.gather(idx)
        t = self._mark("gather", t)
        state = self._device_state(rows, r)
        t = self._mark("host_to_device", t)
        new, out = self.engine.step(state, data, eval_set=eval_set)
        t = self._mark("device_round", t)

        def host(x):
            return x.cpu().numpy()

        def host_rows(x):  # every rank's rows of a (K, d) block
            return host(comms.all_gather(x))

        trust = TrustState(*(host(c) for c in new.trust))
        battery, history = host(new.resources.battery), host_rows(new.fg_history)
        residual = host_rows(new.compress_residual)
        pending = None
        if self.store.pending_dim:
            pending = {name: host(getattr(new, name)) for name in (
                "pending_weight", "pending_issued", "pending_arrival",
                "pending_valid")}
            pending["pending_delta"] = host_rows(new.pending_delta)
        t = self._mark("device_to_host", t)
        self.params = new.params
        self.store.scatter_round(idx, valid, trust=trust, battery=battery,
                                 history=history, residual=residual,
                                 pending=pending)
        t = self._mark("scatter_round", t)
        self.store.finish_round(idx, valid, elig)
        self._mark("finish_round", t)
        return idx, valid, out

    def run(self, fleet, *, rounds: int, eval_set=None):
        """``rounds`` store-sampled rounds -> a list of per-round ``(idx,
        valid, RoundOutputs of numpy arrays)``."""
        if fleet.num_clients != self.fed.num_clients:
            raise ValueError(
                f"fleet has {fleet.num_clients} clients but FedConfig."
                f"num_clients={self.fed.num_clients}"
            )
        outs = []
        for _ in range(rounds):
            idx, valid, out = self.run_round(fleet, eval_set=eval_set)
            outs.append((idx, valid,
                         RoundOutputs(*(f.cpu().numpy() for f in out))))
        return outs
