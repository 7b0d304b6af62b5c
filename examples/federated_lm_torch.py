"""Federated LM through the port's FedAR engine (PyTorch + CUDA): the
port's copy of ``examples/federated_lm.py``, with the same arguments plus
``--device`` and ``--full_width``.

A fleet of robots each holding a topic-skewed slice of a synthetic corpus
(``corpus_skew``, the text analogue of label skew) trains a reduced
TinyLlama-family model through ``FedARServer`` / ``FedAREngine``, the same
engine the paper's MNIST fleet runs: trust scoring, straggler masking,
buffered async aggregation and the cluster-aware sketched FoolsGold
defense apply unchanged, because the nested transformer params cross the
aggregation boundary through the engine's ``flatten`` / ``unflatten``.
Poisoner robots get their next-token labels scrambled.

It runs on the card (``--device cuda``, the default); ``--device cpu``
runs it on the CPU.  ``--devices k > 1`` runs the engine sharded over a
mesh of k client shards (``repro_torch.core.distributed.spawn``): one
process per card over NCCL, or k CPU processes over gloo with ``--device
cpu``; rank 0 prints.  ``--clients`` must divide by k.  ``--full_width``
trains the architecture at its published size instead of the reduced
2-layer model.  A client's virtual round then takes ~5e4-1.4e5 s of the
latency model at tinyllama-1.1b's 1.1e9 params, against the reduced
model's 10 s timeout, so the timeout is worked out from the fleet's own
latencies (``core.engine.median_arrival_timeout``: at least half of the
honest robots arrive in time every round).  Each round's wall seconds are
printed, and the steady rounds/s over rounds 2 on.

Run:  PYTHONPATH=src python examples/federated_lm_torch.py [--rounds 8]
      PYTHONPATH=src python examples/federated_lm_torch.py --compare
      PYTHONPATH=src python examples/federated_lm_torch.py --full_width \\
          --rounds 4 --devices 4
"""
import argparse
import dataclasses
import sys
import time

import numpy as np


def run(args, *, aggregation, defense, label):
    import torch

    from repro_torch import FedARServer, LMClientModel, TaskRequirement, fleet_fed
    from repro_torch.configs import get_config
    from repro_torch.core.engine import median_arrival_timeout
    from repro_torch.data.pipeline import federated_lm_corpus
    from repro_torch.models.model import param_count

    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = cfg.reduced(num_layers=2, d_model=128, d_ff=256, vocab_size=512)
    mesh = None
    if args.devices > 1:
        import torch.distributed as dist

        mesh = dist.get_world_size()  # spawn may narrow k to the cards
    model = LMClientModel(cfg, device=args.device)
    fed = fleet_fed(
        args.clients,
        local_epochs=2,
        local_batch_size=8,
        timeout=10.0,
        aggregation=aggregation,
        defense=defense,
        mesh_shape=mesh,
    )
    params = None
    if args.full_width:
        # the engine's own init (a CPU generator seeded by fed.seed), made
        # here to count the params the latency model uploads
        params = model.init(torch.Generator().manual_seed(fed.seed), args.device)
        flops = model.train_flops((args.samples, args.seq), epochs=fed.local_epochs)
        fed = dataclasses.replace(fed, timeout=median_arrival_timeout(
            fed, train_flops=flops, model_bytes=4.0 * param_count(params),
            rounds=args.rounds, device=args.device))
        print(f"  timeout {fed.timeout:.1f} virtual s (the honest clients' "
              f"median latency at full width)")
    server = FedARServer(model, fed, TaskRequirement(), lr=args.lr, device=args.device,
                         init_params=params)
    if server.mesh is not None:
        print(f"  mesh: {server.mesh.size} client shards x "
              f"{args.clients // server.mesh.size} clients")

    # align the data attack with the fleet's designated poisoner robots
    poisoners = tuple(int(i) for i in np.where(server.poison_mask)[0])
    data, meta = federated_lm_corpus(
        args.clients,
        vocab=cfg.vocab_size,
        seq=args.seq,
        samples_per_client=args.samples,
        topics=args.topics,
        poisoners=poisoners,
        seed=args.seed,
    )
    print(f"  [{label}] {args.clients} clients, shards "
          f"{tuple(data['tokens'].shape)}, poisoners {list(poisoners)}, "
          f"aggregation={aggregation} defense={defense}, on {server.engine.device}")

    def sync():
        if server.engine.device.type == "cuda":
            torch.cuda.synchronize(server.engine.device)

    data = server.engine.device_data(data)
    walls = []
    for _ in range(args.rounds):
        sync()
        t0 = time.perf_counter()
        server.run_round(data, eval_set=meta["eval"])
        sync()
        walls.append(time.perf_counter() - t0)
    hist = server.history
    dt = sum(walls)

    print("  round  loss    token_acc  stragglers  mean_trust")
    for i, (lo, a) in enumerate(zip(hist["loss"], hist["acc"])):
        late = int((~hist["on_time"][i] & hist["selected"][i]).sum())
        print(f"  {i:5d}  {lo:6.3f}  {a:9.3f}  {late:10d}  "
              f"{float(np.mean(hist['trust'][i])):10.1f}")
    if poisoners:
        final_trust = np.asarray(hist["trust"][-1])
        honest = np.setdiff1d(np.arange(args.clients), poisoners)
        print(f"  final trust: poisoners {final_trust[list(poisoners)].mean():.1f}"
              f" vs honest {final_trust[honest].mean():.1f}")
    print(f"  -> final loss {hist['loss'][-1]:.4f} ({dt:.1f}s)")
    steady = (f"; steady (rounds 2-{args.rounds}) "
              f"{(args.rounds - 1) / sum(walls[1:]):.4f} rounds/s"
              if args.rounds > 1 else "")
    print(f"  round seconds {[round(w, 4) for w in walls]}{steady}")
    return hist


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--samples", type=int, default=24,
                    help="sequences per client")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--topics", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=1,
                    help="client shards; >1 runs the engine sharded over k "
                         "processes (one a card, or gloo ranks on the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    ap.add_argument("--baseline", action="store_true",
                    help="run ONLY the plain-FedAvg/no-defense baseline")
    ap.add_argument("--compare", action="store_true",
                    help="run FedAR then the baseline and compare")
    ap.add_argument("--full_width", action="store_true",
                    help="train the architecture at its published size, not "
                         "the reduced 2-layer model")
    args = ap.parse_args(argv)
    if args.devices > 1 and args.clients % args.devices:
        ap.error(f"--clients {args.clients} must divide by --devices "
                 f"{args.devices}")
    return args


def main(argv=None):
    """Run the example; with ``--devices k > 1`` in k ranks, returning rank
    0's results."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.devices > 1:
        from repro_torch.core.distributed import spawn

        return spawn(args.devices, run_all, argv, device=args.device)[0]
    return run_all(argv)


def run_all(argv):
    """The example's runs (FedAR, the baseline, or both) in this process."""
    args = parse_args(argv)
    results = {}
    if not args.baseline:
        print(f"== FedAR federated LM ({args.arch}) ==")
        results["fedar"] = run(
            args, aggregation="async", defense="foolsgold_sketch",
            label="fedar",
        )
    if args.baseline or args.compare:
        print("== plain FedAvg baseline (no defense) ==")
        results["baseline"] = run(
            args, aggregation="fedavg", defense="none", label="baseline",
        )
    if args.compare:
        f, b = results["fedar"], results["baseline"]
        print(f"\nFedAR final {f['loss'][-1]:.4f} vs baseline "
              f"{b['loss'][-1]:.4f} (both converge; FedAR additionally "
              f"masks stragglers and down-weights the poisoners)")
    return results


if __name__ == "__main__":
    main()
