"""Federated LM through the port's FedAR engine (PyTorch + CUDA): the
port's copy of ``examples/federated_lm.py``, with the same arguments.

A fleet of robots each holding a topic-skewed slice of a synthetic corpus
(``corpus_skew``, the text analogue of label skew) trains a reduced
TinyLlama-family model through ``FedARServer`` / ``FedAREngine``, the same
engine the paper's MNIST fleet runs: trust scoring, straggler masking,
buffered async aggregation and the cluster-aware sketched FoolsGold
defense apply unchanged, because the nested transformer params cross the
aggregation boundary through the engine's ``flatten`` / ``unflatten``.
Poisoner robots get their next-token labels scrambled.

It runs on the card (``--device cuda``, the default); ``--device cpu``
runs it on the CPU.  ``--devices k > 1`` (a mesh of client shards) is not
ported yet and raises (ROADMAP Queue 1 item 12).

Run:  PYTHONPATH=src python examples/federated_lm_torch.py [--rounds 8]
      PYTHONPATH=src python examples/federated_lm_torch.py --compare
"""
import argparse
import time

import numpy as np


def run(args, *, aggregation, defense, label):
    from repro_torch import FedARServer, LMClientModel, TaskRequirement, fleet_fed
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import federated_lm_corpus

    cfg = get_config(args.arch).reduced(
        num_layers=2, d_model=128, d_ff=256, vocab_size=512
    )
    model = LMClientModel(cfg, device=args.device)
    fed = fleet_fed(
        args.clients,
        local_epochs=2,
        local_batch_size=8,
        timeout=10.0,
        aggregation=aggregation,
        defense=defense,
    )
    server = FedARServer(model, fed, TaskRequirement(), lr=args.lr, device=args.device)

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

    t0 = time.time()
    hist = server.run(data, rounds=args.rounds, eval_set=meta["eval"])
    dt = time.time() - t0

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
    return hist


def main(argv=None):
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
                    help="client shards; >1 would run the mesh-sharded engine")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    ap.add_argument("--baseline", action="store_true",
                    help="run ONLY the plain-FedAvg/no-defense baseline")
    ap.add_argument("--compare", action="store_true",
                    help="run FedAR then the baseline and compare")
    args = ap.parse_args(argv)

    if args.devices > 1:
        raise NotImplementedError(
            f"--devices {args.devices}: the mesh-sharded engine is not ported "
            f"yet (ROADMAP.md Queue 1 item 12)"
        )

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
