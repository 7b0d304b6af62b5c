"""Poisoning-attack defense demo through the port (PyTorch + CUDA), at paper
scale and engine scale: the port's copy of ``examples/poisoning_defense.py``,
with the same arguments plus ``--device``.

Default (the paper's §IV.A setup): two of 12 robots flip 80% of their
labels; FoolsGold similarity re-weighting + the deviation ban keep the
global model clean, and disabling both lets the attack degrade accuracy.

``--clients N`` (> 12) switches to the engine-scale story: a tiled
homogeneous fleet where 25% of the clients form a replica sybil clique (one
poisoned shard duplicated across identities, the Fung et al. threat
model).  There the dense statistic misfires on honest look-alikes, so the
default strategy becomes the cluster-aware ``foolsgold_sketch``
(``--defense`` overrides).  ``--dataset`` swaps the sample pool the fleets
draw from: the deterministic synthetic digits, or real ``mnist`` /
``emnist`` IDX files from the local cache dir (the offline synthetic
fallback when uncached).

It runs on the card (``--device cuda``, the default); ``--device cpu`` runs
it on the CPU.  ``--devices k > 1`` runs both engines sharded over a mesh
of k client shards (``repro_torch.core.distributed.spawn``): one process
per card over NCCL, or k CPU processes over gloo with ``--device cpu``;
rank 0 prints.  ``--clients`` must divide by k.

Run:  PYTHONPATH=src python examples/poisoning_defense_torch.py
      PYTHONPATH=src python examples/poisoning_defense_torch.py --clients 128
      PYTHONPATH=src python examples/poisoning_defense_torch.py --clients 128 --devices 4
"""
import argparse
import sys

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--samples", type=int, default=300,
                    help="samples per client")
    ap.add_argument("--defense", default=None,
                    choices=["none", "foolsgold", "foolsgold_sketch"],
                    help="defense strategy (default: foolsgold at 12 "
                         "robots, foolsgold_sketch at engine scale)")
    ap.add_argument("--devices", type=int, default=1,
                    help="client shards; >1 runs the engines sharded over k "
                         "processes (one a card, or gloo ranks on the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    ap.add_argument("--dataset", default="synthetic",
                    choices=["synthetic", "mnist", "emnist"],
                    help="sample pool for the fleets (cached IDX files or "
                         "the deterministic offline fallback)")
    ap.add_argument("--compress", default="none",
                    choices=["none", "qsgd", "topk"],
                    help="uplink delta compression with error feedback; "
                         "both the defended and undefended runs use it")
    ap.add_argument("--compress_bits", type=int, default=8,
                    choices=[4, 8],
                    help="qsgd quantization width (bits per coordinate)")
    ap.add_argument("--compress_k", type=int, default=None,
                    help="topk coordinates kept per client "
                         "(default: model_dim // 32)")
    ap.add_argument("--faults", default="none",
                    choices=["none", "crash", "corrupt", "battery",
                             "flaky", "chaos"],
                    help="deterministic fault injection (core/faults.py) "
                         "on top of the poisoning attack; both runs inject "
                         "the identical schedule")
    ap.add_argument("--fault_rate", type=float, default=None,
                    help="override the per-round crash AND corrupt-emission "
                         "probabilities of the chosen fault schedule")
    ap.add_argument("--cache_dir", default=None,
                    help="IDX cache dir for mnist/emnist (default: "
                         "$FEDAR_DATA_DIR or ~/.cache/fedar)")
    args = ap.parse_args(argv)

    if args.clients != 12 and args.clients < 64:
        # the cluster-aware statistic fires on cliques that outgrow the
        # fleet's natural cluster scale (slack * median multiplicity); a 25%
        # clique of a tiny fleet stays inside it and the demo shows nothing
        ap.error("engine-scale demo needs --clients >= 64 (a N/4 replica "
                 "clique below that is within the natural cluster scale "
                 "and is not down-weighted)")
    if args.devices > 1 and args.clients % args.devices:
        ap.error(f"--clients {args.clients} must divide by --devices "
                 f"{args.devices}")
    return args


def fleet(args, defense: str, source):
    """The run's ``FedConfig``, its data dict and (N,) bool attacker mask:
    Table II with two 80% flippers at paper scale, the N/4 sybil clique at
    engine scale."""
    from repro_torch.configs.fedar_mnist import fleet_fed
    from repro_torch.data.federated import sybil_fleet, table2_fleet

    compress_kw = dict(compress=args.compress,
                       compress_bits=args.compress_bits,
                       compress_k=args.compress_k)
    mesh_kw = {}
    if args.devices > 1:
        import torch.distributed as dist

        # spawn may narrow k to the cards there are
        mesh_kw["mesh_shape"] = dist.get_world_size()
    faults_kw = dict(faults=args.faults)
    if args.fault_rate is not None:
        faults_kw.update(fault_crash_rate=args.fault_rate,
                         fault_corrupt_rate=args.fault_rate)
    if args.clients == 12:
        fed = fleet_fed(
            12, local_epochs=3, timeout=30.0, defense=defense,
            deviation_gamma=2.5 if defense != "none" else 1e9,
            **compress_kw, **faults_kw, **mesh_kw,
        )
        data = table2_fleet(samples_per_client=args.samples,
                            flip_frac=0.8, source=source)
        sybils = np.zeros(12, bool)
        sybils[10:] = True
        return fed, data, sybils
    n_syb = args.clients // 4
    fed = fleet_fed(
        args.clients, local_epochs=2, defense=defense,
        num_poisoners=n_syb, num_starved=0, client_fraction=1.0,
        deviation_gamma=1e9,  # isolate the similarity defense
        **compress_kw, **faults_kw, **mesh_kw,
    )
    data, sybils = sybil_fleet(args.clients, n_syb,
                               samples_per_client=args.samples,
                               source=source)
    return fed, data, sybils


def main(argv=None):
    """Runs the demo; returns the defended and the undefended server, the
    defended run's per-client defense weights (engine scale; ``None`` at
    paper scale) and the attacker mask.  With ``--devices k > 1`` it runs
    in k ranks and returns rank 0's defended and undefended histories in
    place of the servers."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.devices > 1:
        from repro_torch.core.distributed import spawn

        return spawn(args.devices, run_ranked, argv, device=args.device)[0]
    return run_demo(args)


def run_ranked(argv):
    """One rank of the demo on a mesh: the histories cross back, not the
    servers."""
    s1, s0, fgw, sybils = run_demo(parse_args(argv))
    return s1.history, s0.history, fgw, sybils


def run_demo(args):
    """The demo itself (see ``main``)."""

    import torch

    from repro_torch.configs.fedar_mnist import MnistConfig
    from repro_torch.core.fedar import FedARServer
    from repro_torch.core.resources import TaskRequirement
    from repro_torch.data.sources import eval_source, get_source

    paper_scale = args.clients == 12
    source = get_source(args.dataset, cache_dir=args.cache_dir)
    if source.fallback:
        print(f"[data] {args.dataset}: no IDX files cached — deterministic "
              "synthetic fallback")
    # held-out eval split, loaded once and shared by both runs
    eval_src, warn = eval_source(args.dataset, source.fallback,
                                 cache_dir=args.cache_dir)
    if warn:
        print(warn)
    ex, ey = eval_src.sample(500, seed=99)

    def run(defense: str):
        fed, data, sybils = fleet(args, defense, source)
        srv = FedARServer(MnistConfig(), fed, TaskRequirement(),
                          device=args.device)
        if srv.mesh is not None and defense != "none":
            print(f"mesh: {srv.mesh.size} client shards x "
                  f"{args.clients // srv.mesh.size} clients")
        srv.run(data, rounds=args.rounds, eval_set=(ex, ey))
        fgw = None
        if defense != "none" and not paper_scale:
            # engine scale: the per-client defense weights over the final
            # history (paper scale catches its 2 independent flippers with
            # the deviation ban, not the similarity statistic)
            active = torch.ones(args.clients, dtype=torch.bool,
                                device=srv.engine.device)
            fgw = srv.engine.defense.weights(srv.fg_history, active,
                                             comms=srv.engine.comms)
            fgw = fgw.cpu().numpy()
        return srv, fgw, sybils

    defense = args.defense or ("foolsgold" if paper_scale
                               else "foolsgold_sketch")
    print(f"defended ({defense}"
          + (" + deviation ban):" if paper_scale else "):"))
    s1, fgw, sybils = run(defense)
    h1 = s1.history
    print("  acc:", [round(a, 3) for a in h1["acc"]])
    if fgw is not None:
        print(f"  defense weights: sybil max {fgw[sybils].max():.3f}  "
              f"honest min {fgw[~sybils].min():.3f}")
    print("undefended:")
    s0, _, _ = run("none")
    h0 = s0.history
    print("  acc:", [round(a, 3) for a in h0["acc"]])
    print(f"\nfinal: defended {h1['acc'][-1]:.3f} "
          f"vs undefended {h0['acc'][-1]:.3f}")
    return s1, s0, fgw, sybils


if __name__ == "__main__":
    main()
