"""The client-mesh cases of tests/test_torch_mesh.py and tests/test_torch_cuda.py,
run by every rank of a spawned job (``repro_torch.core.distributed.spawn``)
and, for the comparison, by the one-process engine.

``run_case(name, shards, device)`` builds one configuration (N = 128
clients, ``small_model(32)``, 4 rounds unless the case says otherwise) on
a mesh of ``shards`` ranks (1: no mesh) and returns what the tests compare,
as numpy: the history rows, the params after every round, the final state
(its (N, ...) blocks this rank's rows), the fault masks of every round, the
payload of round 0 (compressed cases) and the comms' recorded shapes.
``job(names, device)`` runs several cases in one rank, and
``check_case`` holds a mesh's results against the one-process run's.  This
module imports no JAX.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.fedar_mnist import fleet_fed, small_model
from repro_torch.convert import ReplayDraws
from repro_torch.core.engine import FedAREngine
from repro_torch.core.fedar import FedARServer
from repro_torch.core.resources import TaskRequirement
from repro_torch.data.datasets import VirtualFleet, make_federated
from repro_torch.data.federated import scaled_fleet

N = 128
ROUNDS = 4
FORCE = np.arange(N) % 10 == 3  # forced stragglers of the async cases

# name -> FedConfig overrides and the fleet ("scaled", "skew", "padded",
# "drift", "cohort")
CASES = {
    "fedar": dict(aggregation="fedar", defense="none"),
    "fedavg": dict(aggregation="fedavg", defense="none"),
    "async": dict(aggregation="async", defense="none", force=True),
    "async_seq": dict(aggregation="async_seq", defense="none"),
    "foolsgold": dict(defense="foolsgold"),
    "foolsgold_sketch": dict(defense="foolsgold_sketch"),
    "qsgd8": dict(defense="foolsgold_sketch", compress="qsgd", compress_bits=8),
    "qsgd4_async": dict(aggregation="async", defense="foolsgold_sketch",
                        compress="qsgd", compress_bits=4, force=True),
    "topk": dict(defense="foolsgold_sketch", compress="topk", compress_k=256),
    "gated_packed": dict(defense="foolsgold_sketch", select_frac=0.5,
                         fleet="skew"),
    "padded": dict(defense="foolsgold_sketch", fleet="padded"),
    "drift": dict(defense="none", fleet="drift"),
    "chaos": dict(defense="foolsgold_sketch", faults="chaos"),
    "cohort": dict(aggregation="async", defense="foolsgold_sketch",
                   faults="chaos", fleet="cohort"),
}
COHORT_N, COHORT_K = 256, 32


def _fleet(kind: str, shards: int):
    if kind == "skew":
        return make_federated("digits", N, scenario="quantity_skew",
                              samples_per_client=24, seed=9)
    if kind == "padded":  # 127 robots, padded with one inert client
        return make_federated("digits", N - 1, scenario="quantity_skew",
                              samples_per_client=24, seed=13).padded_to(max(shards, 2))
    if kind == "drift":
        return make_federated("digits", N, scenario="robot_drift",
                              samples_per_client=48, windows=3, seed=5)
    return scaled_fleet(N, samples_per_client=40)


@contextlib.contextmanager
def one_thread():
    """Run the block on one intra-op thread (restored after): a test's
    one-process comparison run shares the cores with its spawned ranks
    and the other test workers, and an OpenMP pool waiting at its
    barriers on busy cores runs many times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def run_case(name: str, shards: int, device="cpu", *, replay=None,
             init_params=None, rounds: int = ROUNDS) -> dict:
    """One case on a mesh of ``shards`` ranks (this process is one of
    them; 1 runs the one-process engine).  ``replay``: ``ReplayDraws``
    keyword arrays; ``init_params``: the model's params as numpy."""
    kw = dict(CASES[name])
    kind = kw.pop("fleet", "scaled")
    force = FORCE if kw.pop("force", False) else None
    # a process group of one rank runs the one-rank mesh (MeshComms)
    mesh = shards if shards > 1 or dist.is_initialized() else None
    req = TaskRequirement()
    draws = None if replay is None else ReplayDraws(**replay, device=device)
    if kind == "cohort":
        fed = fleet_fed(COHORT_N, local_epochs=1, cohort_size=COHORT_K,
                        mesh_shape=mesh, **kw)
        server = FedARServer(small_model(32), fed, req, device=device, draws=draws,
                             init_params=init_params)
        fleet = VirtualFleet(COHORT_N, samples_per_client=40, device=device)
        rows = []
        for _ in range(rounds):
            server.run_round(fleet)
            rows.append(_np(server.engine.params))
        hist = server.history
        return dict(
            cohort=[(np.asarray(i), np.asarray(v)) for i, v in hist["cohort"]],
            selected=np.stack(hist["selected"]), on_time=np.stack(hist["on_time"]),
            trust=np.stack(hist["trust"]), params_rounds=np.stack(rows),
            store=server.engine.store.state_dict(),
        )
    fed = fleet_fed(N, local_epochs=1, mesh_shape=mesh, **kw)
    server = FedARServer(small_model(32), fed, req, device=device, draws=draws,
                         init_params=init_params)
    eng = server.engine
    ds = _fleet(kind, shards)
    if kind == "skew":
        data = eng.prepare_data(ds, layout="packed")
    elif kind == "padded":
        data = eng.prepare_data(ds)
    else:
        data = ds.arrays() if hasattr(ds, "arrays") else ds
    payloads = []
    encode = eng.compression.encode

    def recording_encode(*args):
        payload, res = encode(*args)
        payloads.append({k: _np(v) for k, v in payload.items()})
        return payload, res

    if eng.compression.active:
        eng.compression.encode = recording_encode
    rows, faults = [], []
    for _ in range(rounds):
        server.run_round(data, force_straggler=force)
        rows.append(_np(server.state.params))
        if eng.fault_masks is not None:
            faults.append({k: _np(v) for k, v in eng.fault_masks.items()})
    st = server.state
    hist = server.history
    return dict(
        selected=np.stack(hist["selected"]), on_time=np.stack(hist["on_time"]),
        trust=np.stack(hist["trust"]), params_rounds=np.stack(rows),
        fg_history=_np(st.fg_history), pending_delta=_np(st.pending_delta),
        compress_residual=_np(st.compress_residual),
        pending=[_np(getattr(st, f)) for f in ("pending_weight", "pending_issued",
                                               "pending_arrival", "pending_valid")],
        participations=_np(st.trust.participations), failures=_np(st.trust.failures),
        battery=_np(st.resources.battery), faults=faults,
        payload0=payloads[0] if payloads else None,
        # the largest QSGD level (scale / L) of the run: one code flip moves
        # an element by at most this much
        level=max((float(p["scale"].max()) for p in payloads if "scale" in p),
                  default=0.0) / (2 ** (fed.compress_bits - 1) - 1),
        uplink_shapes=list(eng.comms.uplink_payload_shapes),
        uplink_rounds=eng.comms.uplink_rounds,
        defense_shapes=list(eng.comms.defense_gather_shapes),
        dim=eng.dim, layout="packed" if "packed" in (data if isinstance(data, dict) else {})
        else "dense",
        mesh=None if server.mesh is None else (server.mesh.rank, server.mesh.size),
    )


def job(cases, device="cpu") -> dict:
    """Every case of ``cases`` in this rank, on the mesh of the current
    process group: a case is a name of ``CASES``, or a (key, name, keyword
    dict of ``run_case``) triple.  Adds the rank's ``identity_ops``,
    ``divisibility_error`` and ``block_fleet_error`` under "_ops",
    "_divisible" and "_local_fleet"."""
    shards = dist.get_world_size()
    out = {}
    for case in cases:
        key, name, kw = (case, case, {}) if isinstance(case, str) else case
        out[key] = run_case(name, shards, device, **kw)
    out["_ops"] = identity_ops(device)
    out["_divisible"] = divisibility_error(device)
    out["_local_fleet"] = block_fleet_error(device)
    return out


def block_fleet_error(device="cpu") -> str:
    """The error of a fleet of N / k clients handed to an engine of N
    clients on a k-rank mesh (as if it were the whole fleet); the engine's
    own ``device_data`` output goes back in as this rank's block."""
    k = dist.get_world_size()
    eng = FedAREngine(small_model(32), fleet_fed(N, mesh_shape=k, defense="none"),
                      TaskRequirement(), device=device)
    moved = eng.device_data(scaled_fleet(N, samples_per_client=8))
    again = eng.device_data(moved)
    assert all(again[key] is moved[key] for key in moved)
    assert again["x"].shape[0] == N // k
    try:
        eng.device_data(scaled_fleet(N // k, samples_per_client=8))
    except ValueError as e:
        return str(e)
    return ""


def divisibility_error(device="cpu") -> str:
    """The error of a fleet that does not divide by the mesh's ranks."""
    fed = fleet_fed(N + 1, mesh_shape=dist.get_world_size(), defense="none")
    try:
        FedAREngine(small_model(32), fed, TaskRequirement(), device=device)
    except ValueError as e:
        return str(e)
    return ""


def identity_ops(device="cpu", seed: int = 0) -> dict:
    """The collectives on a fixed input, on ``device`` (the rank's card
    under NCCL): psum, all_gather of a bool mask, the tree reduce of a D
    not divisible by k, and a width-0 gather."""
    from repro_torch.core.distributed import MeshComms

    k, r = dist.get_world_size(), dist.get_rank()
    dev = "cpu" if device == "cpu" else torch.device("cuda", torch.cuda.current_device())
    comms = MeshComms(dist.group.WORLD, r, k, tree=True)
    g = torch.Generator().manual_seed(seed + r)
    x = torch.randn(101, generator=g)
    mask = torch.rand(5, generator=g) > 0.5
    return dict(x=x.numpy(), psum=_np(comms.psum(x.to(dev))),
                tree=_np(comms.reduce_tree(x.to(dev))), mask=mask.numpy(),
                gathered=_np(comms.all_gather(mask.to(dev))),
                empty=tuple(comms.all_gather(torch.zeros(3, 0, device=dev)).shape))


def _close_up_to_flips(name, got, want, level):
    """Within atol = rtol = 1e-4 but for at most 1e-3 of the elements, each
    of those within one QSGD level."""
    err = np.abs(got - want)
    over = err > 1e-4 + 1e-4 * np.abs(want)
    assert over.sum() <= 1e-3 * over.size, f"{name}: {int(over.sum())} elements past 1e-4"
    assert err.max(initial=0.0) <= level + 1e-4, f"{name}: {err.max()} past one level {level}"


def check_case(want: dict, ranks: list, case: str, k: int) -> None:
    """Case ``case`` on a k-rank mesh (``ranks``: each rank's result)
    against the one-process run ``want``: selected, on-time, trust, the
    fault masks and the store's integer columns identical; params within
    atol = rtol = 1e-4 and bit-identical on every rank after every round;
    the history, the async buffer and the residual within 1e-4 (under QSGD
    up to code flips, ``_close_up_to_flips``)."""
    got = ranks[0]
    for key in ("selected", "on_time", "trust"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for r, rank in enumerate(ranks[1:], 1):  # replicated, bit for bit
        for key in ("params_rounds", "selected", "trust"):
            np.testing.assert_array_equal(rank[key], got[key], err_msg=f"rank {r} {key}")
    np.testing.assert_allclose(got["params_rounds"], want["params_rounds"],
                               atol=1e-4, rtol=1e-4)
    if case == "cohort":
        for (i, v), (wi, wv) in zip(got["cohort"], want["cohort"]):
            np.testing.assert_array_equal(i, wi)
            np.testing.assert_array_equal(v, wv)
        for rank in ranks:  # every rank's store is the same
            for col, val in rank["store"].items():
                if np.asarray(val).dtype.kind == "f":
                    np.testing.assert_allclose(val, want["store"][col], atol=1e-4,
                                               rtol=1e-4, err_msg=col)
                else:
                    np.testing.assert_array_equal(val, want["store"][col], err_msg=col)
        return
    assert got["mesh"] == (0, k)
    for key in ("participations", "failures", "battery"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for a, b in zip(got["pending"], want["pending"]):
        np.testing.assert_array_equal(a, b)
    for key in ("fg_history", "pending_delta", "compress_residual"):
        full = np.concatenate([r[key] for r in ranks])
        assert full.shape == want[key].shape, key
        if case.startswith("qsgd"):
            _close_up_to_flips(key, full, want[key], want["level"])
        else:
            np.testing.assert_allclose(full, want[key], atol=1e-4, rtol=1e-4, err_msg=key)
    assert len(got["faults"]) == len(want["faults"])
    for a, b in zip(got["faults"], want["faults"]):
        for m in b:
            np.testing.assert_array_equal(a[m], b[m], err_msg=m)
    if case == "chaos":
        assert any(f["quarantined"].any() for f in want["faults"])
    if case in ("gated_packed", "padded"):
        assert got["layout"] == "packed"
