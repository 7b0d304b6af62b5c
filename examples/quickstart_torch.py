"""Quickstart through the port (PyTorch + CUDA): the port's copy of
``examples/quickstart.py``, with the same arguments plus ``--device``.

The paper's 12-robot FedAR simulation through ``FedARServer``; pass
``--clients N`` to scale the fleet past the paper's 12 robots.
``--dataset`` picks a fleet from the federated dataset registry
(``repro_torch/data/datasets.py``): ``auto`` keeps the legacy behavior
(Table II at 12 robots, the tiled ``scaled`` fleet beyond), while
``mnist`` / ``emnist`` / ``digits`` run a sample pool (real IDX files from
the local cache dir, or the deterministic offline synthetic fallback, never
the network) through a named non-IID ``--scenario`` (``iid`` |
``label_skew`` | ``quantity_skew`` | ``robot_drift``).  The engine picks the
client-data layout (the rectangular pad-to-max one or the bucketed packed
one) per fleet from its padding-waste estimate; ``--no-packed`` /
``--packed`` force it.

``--faults chaos`` turns on the deterministic fault-injection schedule
(mid-round crashes, garbage uplinks, battery death, flapping links); the
engine's non-finite quarantine keeps the global model finite, faulty rows
aggregating with exactly-zero weight.

It runs on the card (``--device cuda``, the default); ``--device cpu`` runs
it on the CPU.  ``--devices k > 1`` runs the engine sharded over a mesh of k
client shards (``repro_torch.core.distributed.spawn``): one process per
card over NCCL, or k CPU processes over gloo with ``--device cpu``; rank 0
prints.  A fleet that does not divide by k is padded with inert clients,
and ``--cohort K`` must divide by k.

Each round's wall seconds are printed at the end, and the steady rounds/s
over rounds 2 on.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--clients 128]
      PYTHONPATH=src python examples/quickstart_torch.py --clients 512 \\
          --dataset emnist --scenario quantity_skew --select_frac 0.5
      PYTHONPATH=src python examples/quickstart_torch.py --clients 64 \\
          --rounds 5 --faults chaos
      PYTHONPATH=src python examples/quickstart_torch.py --clients 100000 \\
          --cohort 256 --aggregation async --compress qsgd --faults chaos
      PYTHONPATH=src python examples/quickstart_torch.py --clients 512 \\
          --dataset emnist --scenario quantity_skew --select_frac 0.5 --devices 4
(the last line holds 2 x 100,000 x 101,770 fp32 residual and pending
columns on the host: 81.4 GB of host memory)
"""
import argparse
import sys

import numpy as np

# scaled fleets past this size auto-enable the host-store cohort engine:
# the resident engine would materialize O(N * n * 784) client data
AUTO_COHORT_CLIENTS = 4096
AUTO_COHORT_SIZE = 512


def parse_args(argv=None):
    """The parser and the parsed arguments."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--devices", type=int, default=1,
                    help="client shards; >1 runs the engine sharded over k "
                         "processes (one a card, or gloo ranks on the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    ap.add_argument("--dataset", default="auto",
                    choices=["auto", "table2", "scaled", "digits", "mnist",
                             "emnist"],
                    help="fleet builder (auto: table2 at 12 robots, scaled "
                         "beyond); mnist/emnist load cached IDX files or "
                         "fall back to deterministic synthetic digits")
    ap.add_argument("--scenario", default=None,
                    choices=["iid", "label_skew", "quantity_skew",
                             "robot_drift"],
                    help="non-IID split for the pool datasets "
                         "(digits/mnist/emnist); default label_skew")
    ap.add_argument("--samples", type=int, default=300,
                    help="samples per client")
    ap.add_argument("--packed", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="force the bucketed packed layout on or off; by "
                         "default the engine picks per fleet from the "
                         "padding-waste estimate (scenarios.pick_layout). "
                         "--no-packed forces the rectangular pad-to-max "
                         "layout")
    ap.add_argument("--select_frac", type=float, default=None,
                    help="selection-gated local SGD: cap the SGD cohort at "
                         "ceil(frac * N) and skip unselected clients' "
                         "compute (>= 0.5, the selection fraction; numerics "
                         "unchanged)")
    ap.add_argument("--cohort", type=int, default=None,
                    help="host-store cohort mode: keep the fleet in a "
                         "numpy client store and run each round on a "
                         "sampled cohort of K clients (device memory O(K), "
                         "fleet size unbounded).  Auto-enabled at K=512 "
                         f"for scaled fleets past {AUTO_COHORT_CLIENTS} "
                         "clients; pass K >= clients to force the "
                         "resident engine.  At --clients 100000 with "
                         "--aggregation async --compress qsgd the store "
                         "holds 81.4 GB of host memory")
    ap.add_argument("--compress", default="none",
                    choices=["none", "qsgd", "topk"],
                    help="uplink delta compression with error feedback "
                         "(core/compress.py): qsgd stochastic quantization "
                         "or magnitude top-k; none is bit-identical to the "
                         "uncompressed engine")
    ap.add_argument("--compress_bits", type=int, default=8,
                    choices=[4, 8],
                    help="qsgd quantization width (bits per coordinate)")
    ap.add_argument("--compress_k", type=int, default=None,
                    help="topk coordinates kept per client "
                         "(default: model_dim // 32)")
    ap.add_argument("--aggregation", default="fedar",
                    choices=["fedar", "fedavg", "async"],
                    help="aggregation rule: the paper's straggler-masked "
                         "fedar, plain fedavg, or buffered async (late "
                         "uplinks land in a pending buffer and merge next "
                         "round; composes with --cohort)")
    ap.add_argument("--faults", default="none",
                    choices=["none", "crash", "corrupt", "battery",
                             "flaky", "chaos"],
                    help="deterministic fault injection (core/faults.py): "
                         "mid-round crashes, garbage uplinks, battery-death "
                         "windows, flapping connectivity, or all four "
                         "(chaos), keyed on (seed, round, client id)")
    ap.add_argument("--fault_rate", type=float, default=None,
                    help="override the per-round crash AND corrupt-emission "
                         "probabilities of the chosen fault schedule "
                         "(defaults: crash 0.1, corrupt 0.5)")
    ap.add_argument("--alpha", type=float, default=None,
                    help="Dirichlet concentration for the skew scenarios; "
                         "default 0.5")
    ap.add_argument("--cache_dir", default=None,
                    help="IDX cache dir for mnist/emnist (default: "
                         "$FEDAR_DATA_DIR or ~/.cache/fedar)")
    return ap, ap.parse_args(argv)


def build(argv=None):
    """Parse ``argv`` and set the run up as ``main`` does: returns (args,
    the fleet, the server, the round's data (a dict on the server's device,
    or the fleet in cohort mode), the (x, y) eval set).  With ``--devices
    k > 1`` it runs in each rank of a process group of k ranks (``main``
    starts them)."""
    ap, args = parse_args(argv)
    shards = args.devices if args.devices > 1 else 1
    if shards > 1:
        import torch.distributed as dist

        shards = dist.get_world_size()  # spawn may narrow k to the cards

    from repro_torch import FedARServer, TaskRequirement, make_federated
    from repro_torch.configs.fedar_mnist import MnistConfig, fleet_fed
    from repro_torch.data.datasets import VirtualFleet
    from repro_torch.data.scenarios import bucket_widths
    from repro_torch.data.sources import eval_source

    name = args.dataset
    if name == "auto":
        name = "table2" if args.clients == 12 else "scaled"
    if name not in ("digits", "mnist", "emnist") and (
        args.scenario is not None or args.alpha is not None
    ):
        # the legacy fleets (table2 / scaled) have no scenario axis
        ap.error(f"--scenario/--alpha apply only to the pool datasets "
                 f"(digits/mnist/emnist), not to dataset={name!r}")

    cohort = args.cohort
    if (cohort is None and name == "scaled"
            and args.clients > AUTO_COHORT_CLIENTS):
        cohort = AUTO_COHORT_SIZE
        print(f"[store] {args.clients} clients exceed "
              f"{AUTO_COHORT_CLIENTS}: auto-enabling the host-store "
              f"cohort engine (K={cohort}; --cohort overrides)")
    cohort_mode = cohort is not None and cohort < args.clients
    if cohort_mode:
        if args.select_frac is not None:
            ap.error("--select_frac composes with the resident engine "
                     "only; in cohort mode the cohort IS the statically-"
                     "capped set — lower --cohort instead")
        if args.packed is not None:
            ap.error("--packed/--no-packed pick a resident layout; the "
                     "cohort engine always runs the K-client masked "
                     "dense layout")

    if cohort_mode and name == "scaled":
        # lazy fleet: N is a property of the store, never an (N, n, 784)
        # array
        ds = VirtualFleet(args.clients, samples_per_client=args.samples,
                          device=args.device)
        print(f"[data] dataset=virtual (lazy scaled fleet) "
              f"clients={ds.num_clients} n_u={ds.samples}")
    else:
        kw = {}
        if name in ("digits", "mnist", "emnist"):
            kw["scenario"] = args.scenario or "label_skew"
            if kw["scenario"] == "iid":
                if args.alpha is not None:
                    ap.error("--alpha applies to the skewed scenarios "
                             "(label_skew/quantity_skew/robot_drift), "
                             "not iid")
            else:
                kw["alpha"] = 0.5 if args.alpha is None else args.alpha
        ds = make_federated(name, args.clients,
                            samples_per_client=args.samples,
                            cache_dir=args.cache_dir, **kw)
        if ds.fallback:
            print(f"[data] {name}: no IDX files in the cache dir — using "
                  "the deterministic offline synthetic fallback")
        print(f"[data] dataset={ds.name} scenario={ds.scenario or '-'} "
              f"shards={ds.x.shape} mean n_u={ds.sizes.mean():.0f}")
        if not cohort_mode and ds.num_clients % shards:
            # inert dummy clients (all-False masks, exactly-zero
            # aggregation weight) so that the mesh shards evenly
            ds = ds.padded_to(shards)
            print(f"[data] fleet padded {args.clients} -> {ds.num_clients} "
                  f"clients to divide by {shards} shards")

    # the paper's B=20, E=5 setting, at any fleet size.  The paper's 12
    # heterogeneous robots take the dense FoolsGold statistic; the tiled
    # fleet has many honest clients per Table II profile, where the dense
    # max-cosine misfires, so engine scale takes the cluster-aware sketched
    # defense (core/defense.py)
    if cohort_mode and cohort % shards:
        ap.error(f"--cohort {cohort} must divide by --devices {shards} (the "
                 f"cohort is what shards)")
    faults_kw = dict(faults=args.faults)
    if args.fault_rate is not None:
        faults_kw.update(fault_crash_rate=args.fault_rate,
                         fault_corrupt_rate=args.fault_rate)
    fed = fleet_fed(ds.num_clients, local_epochs=5, local_batch_size=20,
                    timeout=10.0,
                    aggregation=args.aggregation,
                    defense="foolsgold_sketch" if cohort_mode
                    else "foolsgold" if args.clients == 12
                    else "foolsgold_sketch",
                    select_frac=args.select_frac,
                    cohort_size=cohort,
                    compress=args.compress,
                    compress_bits=args.compress_bits,
                    compress_k=args.compress_k,
                    mesh_shape=shards if shards > 1 else None,
                    **faults_kw)
    if args.faults != "none":
        print(f"[faults] schedule={args.faults}: non-finite quarantine "
              f"armed (cap {fed.resolved_quarantine_cap:g}); faulty rows "
              "aggregate with exactly-zero weight")
    server = FedARServer(MnistConfig(), fed, TaskRequirement(),
                         device=args.device)
    if server.mesh is not None:
        rows = (cohort if server.cohort_mode else ds.num_clients) // shards
        print(f"mesh: {shards} client shards x {rows} clients")
    if args.compress != "none":
        payload = server.engine.compression.payload_nbytes(server.engine.dim)
        print(f"[uplink] compress={args.compress}: "
              f"{payload} bytes/client/round "
              f"vs dense {4 * server.engine.dim}")

    if server.cohort_mode:
        print(f"[store] host client store: {ds.num_clients} clients, "
              f"cohort K={cohort} on device per round")
        data = ds  # the fleet object; each round materializes K shards
    else:
        # dense vs bucketed packed is the engine's call (pick_layout on the
        # fleet's padding-waste estimate) unless --packed / --no-packed
        # forces it
        layout = ("auto" if args.packed is None
                  else "packed" if args.packed else "dense")
        if hasattr(ds, "materialize"):
            ds = ds.materialize()  # K >= N: back to the resident engine
        data = server.engine.prepare_data(ds, layout=layout)
        if "packed" in data:
            B = fed.local_batch_size
            widths = sorted(set(bucket_widths(
                ds.client_extents(), ds.samples, quantum=B).astype(int).tolist()))
            tiles = data["packed"].tile_mask.shape[0]
            print(f"[data] layout=packed: {len(widths)} buckets, "
                  f"widths {widths}; {tiles} batch tiles against "
                  f"{ds.num_clients * -(-ds.samples // B)} for the rectangle")
        else:
            print(f"[data] layout=dense: pad-to-max {data['x'].shape[1]}")
    # evaluate on the held-out split of the same source (test IDX files when
    # cached, the synthetic generator otherwise)
    eval_name = name if name in ("mnist", "emnist") else "synthetic"
    eval_src, warn = eval_source(eval_name, ds.fallback,
                                 cache_dir=args.cache_dir)
    if warn:
        print(warn)
    return args, ds, server, data, eval_src.sample(500, seed=99)


def run(argv=None):
    """Build the run and drive it (in one rank of the mesh with ``--devices
    k > 1``); returns the server's history."""
    import time

    import torch

    args, _, server, data, eval_set = build(argv)
    dev = server.engine.device
    walls = []
    for _ in range(args.rounds):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        server.run_round(data, eval_set=eval_set)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    hist = server.history

    print("\nround  accuracy  loss    stragglers")
    for i, (a, lo) in enumerate(zip(hist["acc"], hist["loss"])):
        late = int((~hist["on_time"][i] & hist["selected"][i]).sum())
        print(f"{i:5d}  {a:8.3f}  {lo:6.3f}  {late}")
    if server.cohort_mode:
        score = np.asarray(server.trust.score)
        head = min(24, len(score))
        print(f"\nfinal trust scores (store head, {head} of {len(score)}):")
        print(np.round(score[:head], 1))
    else:
        print("\nfinal trust scores per robot:")
        print(np.round(hist["trust"][-1], 1))
    print("\n(resource-starved robots are never selected, trust ~50;")
    print(" reliable robots accumulate C_Reward; stragglers get penalties)")
    steady = (f"; steady (rounds 2-{args.rounds}) "
              f"{(args.rounds - 1) / sum(walls[1:]):.3f} rounds/s"
              if args.rounds > 1 else "")
    print(f"round seconds {[round(w, 4) for w in walls]}{steady}")
    return hist


def main(argv=None):
    """Run the quickstart; with ``--devices k > 1`` in k ranks, returning
    rank 0's history."""
    argv = sys.argv[1:] if argv is None else list(argv)
    _, args = parse_args(argv)
    if args.devices > 1:
        from repro_torch.core.distributed import spawn

        return spawn(args.devices, run, argv, device=args.device)[0]
    return run(argv)


if __name__ == "__main__":
    main()
