"""The client mesh: the FedAR round sharded over blocks of clients, one
process per card, with ``torch.distributed`` collectives (NCCL on the
cards, gloo on the CPU).

``FedAREngine`` runs on a mesh when ``FedConfig.mesh_shape`` is k > 1 and
the process belongs to a process group of k ranks (``spawn`` starts one).
Every client-indexed ``(N, ...)`` tensor (the stacked local datasets or
the rank's packed buckets, the defense history, the buffered-async delta
buffer, the error-feedback residual) splits into ``N / k`` blocks, rank r
holding clients ``[r N/k, (r+1) N/k)``.  The ``(N,)`` bookkeeping (trust,
resources, masks, selection) is replicated: every rank computes it from
the same draws, so selection's global sort and the Algorithm 1 trust
updates are the one-device engine's.

Exports:

  ``ClientComms``  -- identity collectives: the one-device engine, and the
                      comms-parameterized math of ``core/aggregation`` /
                      ``core/foolsgold`` reduced to the one-device numerics;
                      ``IDENTITY``, one that records nothing, is those
                      functions' default.
  ``MeshComms``    -- the same interface over a process group: aggregation
                      becomes a trust x staleness weighted ``all_reduce``
                      of (D,) partials (or a reduce-scatter + all-gather
                      tree), and the defense's pairwise similarity a
                      gathered block product.  ``gather_defense`` carries
                      the defense payload, (N, r) sketches for
                      ``foolsgold_sketch`` or the dense (N, D) history, and
                      records the gathered shapes.
  ``ClientMesh``   -- this rank's place in the mesh (group, rank, size,
                      device).
  ``client_mesh``  -- ``FedConfig`` -> ``ClientMesh`` (``None`` on one
                      device).
  ``spawn``        -- run a function in k ranks: one process per card
                      (NCCL) or k CPU processes (gloo).

The reference's ``PartitionSpec`` helpers (``client_spec``,
``window_client_spec``, ``replicated_spec``, ``packed_specs``) have no
counterpart here: their job, placing each rank's block of the data, is the
engine's slicing of the data dict (``FedAREngine.device_data``): the dense
per-client arrays along axis 0, the drift ``round_mask`` along axis 1, and
the packed buckets by the shard-major row blocks that
``FederatedDataset.packed_arrays(shards=k)`` lays out, ``inv`` by the
rank's clients.

Every rank issues the same collectives in the same order (no
rank-dependent branch reaches one), and bool masks cross the wire as
uint8.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import sys
import tempfile
import warnings
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.common.config import FedConfig


def _all_gather_rows(out, x, group):
    # torch renamed the tensor collectives (``*_single``); older releases
    # have only the ``*_tensor`` names
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _reduce_scatter_rows(out, x, group):
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, x, op=dist.ReduceOp.SUM, group=group)


class ClientComms:
    """Collective vocabulary of the engine's round math, identity flavour.

    The round is written once against this interface; on one device every
    method is the identity.  Convention: "local" tensors hold this rank's
    block of clients along axis 0; "global" ones hold all N clients
    (replicated on every rank)."""

    axis: Optional[str] = None
    shards: int = 1
    rank: int = 0

    def __init__(self, *, record: bool = True):
        # what crossed the wire, each distinct value once in the order first
        # seen (the engine records every round, so the lists stay bounded):
        # the gathered defense payload's shape, (N, r) for the sketched
        # defense and (N, D) for the dense one; the compressed uplink's
        # leaves in key order, ((shape, dtype name), ...) of this rank's
        # rows, packed uint8 codes or (k,) pairs, never re-densified fp32.
        # ``uplink_rounds`` counts the uplinks recorded.  ``record=False``
        # (the default comms of the aggregation and defense functions)
        # keeps nothing.
        self.record = record
        self.defense_gather_shapes: list = []
        self.uplink_payload_shapes: list = []
        self.uplink_rounds = 0

    def _note(self, seen: list, value) -> None:
        if self.record and value not in seen:
            seen.append(value)

    def record_uplink(self, payload: dict) -> None:
        """Record the leaf shapes and dtypes of a compression payload (the
        uplink that crosses the client -> aggregator boundary)."""
        if not self.record:
            return
        self.uplink_rounds += 1
        self._note(self.uplink_payload_shapes, tuple(
            (tuple(payload[k].shape), str(payload[k].dtype).removeprefix("torch."))
            for k in sorted(payload)
        ))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum a rank-local partial across the mesh."""
        return x

    def all_gather(self, x):
        """Concatenate the ranks' local rows into the full (N, ...)."""
        return x

    def local(self, x):
        """This rank's block of a replicated (N, ...) tensor or array."""
        return x

    def gather_defense(self, x: torch.Tensor) -> torch.Tensor:
        """All-gather the defense's unit rows (the sketched (N_loc, r)
        block, or the dense (N_loc, D) one) and record the gathered shape:
        this payload, not the O(N * D) history, is the defense's traffic."""
        out = self.all_gather(x)
        self._note(self.defense_gather_shapes, tuple(out.shape))
        return out

    def reduce_tree(self, x: torch.Tensor) -> torch.Tensor:
        """Cross-rank reduction of a (D,) partial (``MeshComms`` may take it
        as a reduce-scatter + all-gather tree)."""
        return self.psum(x)


# the default ``comms`` of the aggregation and defense functions: identity
# collectives that record nothing, so a shared default holds no state
IDENTITY = ClientComms(record=False)


class MeshComms(ClientComms):
    """The collectives over ``group``: this process is rank ``rank`` of
    ``shards``.  ``tree=True`` (``FedConfig.tree_reduce``, which the
    cohort engine sets) takes ``reduce_tree`` as a reduce-scatter followed
    by an all-gather; the default is one ``all_reduce``."""

    def __init__(self, group, rank: int, shards: int, *, tree: bool = False,
                 axis: str = "clients"):
        super().__init__()
        self.group, self.rank, self.shards = group, rank, shards
        self.tree, self.axis = tree, axis

    def psum(self, x):
        out = x.contiguous().clone()  # all_reduce works in place
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def all_gather(self, x):
        if x.dtype == torch.bool:
            return self.all_gather(x.to(torch.uint8)).to(torch.bool)
        x = x.contiguous()
        out = x.new_empty((self.shards * x.shape[0],) + tuple(x.shape[1:]))
        if x.numel():  # a width-0 block has the same shape on every rank
            _all_gather_rows(out, x, self.group)
        return out

    def local(self, x):
        n = x.shape[0] // self.shards
        return x[self.rank * n:(self.rank + 1) * n]

    def reduce_tree(self, x):
        """Pad D to a multiple of k, reduce-scatter so that each rank sums
        only its D/k slice, all-gather the reduced slices, cut the pad.
        One flat ``all_reduce`` without ``tree``."""
        if not self.tree or self.shards == 1 or x.dim() != 1:
            return self.psum(x)
        d = x.shape[0]
        pad = (-d) % self.shards
        padded = torch.nn.functional.pad(x, (0, pad)).contiguous()
        leaf = x.new_empty(padded.shape[0] // self.shards)
        _reduce_scatter_rows(leaf, padded, self.group)
        full = x.new_empty(padded.shape[0])
        _all_gather_rows(full, leaf, self.group)
        return full[:d]


@dataclass(frozen=True)
class ClientMesh:
    """This process's place in the client mesh: rank ``rank`` of ``size``
    in ``group``, on ``device`` (``cuda:<current device>`` under NCCL, the
    CPU under gloo)."""

    group: Any
    rank: int
    size: int
    device: torch.device
    backend: str


def client_mesh(fed: FedConfig) -> Optional[ClientMesh]:
    """The mesh ``FedConfig.mesh_shape`` asks for, over the default process
    group, or ``None`` for one device (``mesh_shape`` unset, or 1 with no
    process group).  ``mesh_shape=k`` needs a process group of exactly k
    ranks and raises otherwise (``spawn`` narrows k to the cards that
    exist before the group is made); ``num_clients`` must divide by k, so
    that every block is rectangular."""
    if fed.mesh_shape is None:
        return None
    want = fed.mesh_shape
    if not (dist.is_available() and dist.is_initialized()):
        if want > 1:
            raise RuntimeError(
                f"mesh_shape={want} needs a torch.distributed process group of "
                f"{want} ranks, one a card (repro_torch.core.distributed.spawn "
                f"starts one); no process group is initialized"
            )
        return None
    size = dist.get_world_size()
    if size != want:
        raise RuntimeError(
            f"mesh_shape={want} but the process group has {size} rank(s)"
        )
    if fed.num_clients % size:
        raise ValueError(
            f"num_clients={fed.num_clients} not divisible by {size} client "
            f"shards (mesh_shape={want}); pad the fleet "
            f"(FederatedDataset.padded_to)"
        )
    backend = dist.get_backend()
    if backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    elif backend == "gloo":
        device = torch.device("cpu")
    else:
        raise RuntimeError(f"unsupported process group backend {backend!r}")
    return ClientMesh(dist.group.WORLD, dist.get_rank(), size, device, backend)


def _rank_main(rank, k, backend, tmp, timeout, fn, args):
    """One rank of ``spawn``: join the group, run ``fn``, pickle its result
    to ``tmp``.  Ranks past 0 print nothing to standard output."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        # k CPU processes share the host's cores: k OpenMP pools waiting at
        # their barriers on the same cores slow every rank down
        torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), k)
    dist.init_process_group(backend, store=store, rank=rank, world_size=k,
                            timeout=datetime.timedelta(seconds=timeout))
    with open(os.devnull, "w") as sink, \
            contextlib.redirect_stdout(sink if rank else sys.stdout):
        out = fn(*args)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def spawn(k: int, fn, *args, device="cuda", timeout: float = 900.0) -> list:
    """Run ``fn(*args)`` in k ranks of one process group and return the
    ranks' results, rank by rank.

    ``device="cuda"``: one process per card (rank r on ``cuda:r``), NCCL;
    k narrows to the cards that exist, with a warning, and raises when
    there is none.  ``device="cpu"``: k CPU processes, gloo.  The ranks
    meet through a ``FileStore`` in a temporary directory (no TCP port).
    ``fn`` must be importable by name (a module-level function), and its
    result picklable (tensors on the host).  Ranks past 0 print nothing to
    standard output.  A collective that waits past ``timeout`` seconds
    raises; a rank that raises ends the others, and ``spawn`` raises with
    its traceback."""
    dev = torch.device(device)
    if dev.type == "cuda":
        avail = torch.cuda.device_count()
        if avail == 0:
            raise RuntimeError(
                f"{k} client shards on the cards need CUDA devices and there "
                f"is none; pass device='cpu' to run the ranks on the CPU"
            )
        shards = min(k, avail)
        if shards < k:
            warnings.warn(
                f"mesh_shape={k} requested but only {shards} devices "
                f"available; sharding {shards}-way",
                stacklevel=2,
            )
        from repro_torch.kernels import ops

        ops.library()  # built once here, then loaded by every rank
        backend = "nccl"
    elif dev.type == "cpu":
        shards, backend = k, "gloo"
    else:
        raise ValueError(f"spawn runs ranks on cuda or cpu, not {dev}")
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _rank_main, args=(shards, backend, tmp, timeout, fn, args),
            nprocs=shards, start_method="spawn",
        )
        results = []
        for r in range(shards):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
