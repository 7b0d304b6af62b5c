"""Times the buffered-async + 4-bit QSGD round of ``chip_smoke.py``'s
phase 5 (512 clients at full width, foolsgold_sketch, 52 forced
stragglers) on one card, and the QSGD uniforms' draw alone, for one copy
of the port.

``--src`` names the ``src`` directory whose ``repro_torch`` is imported,
so that two versions of the port (say a commit and its parent, each
unpacked with ``git archive``) can be timed on the same card in one
session, run by run: parent, change, change, parent.  Prints the card's
name and power limit, then one JSON line: the round's steady rounds/s
(host clock, rounds 2 on), its median ms, and the uniforms' median device
ms (CUDA events).

Run:  python scripts/time_qsgd_round.py --src src --label change
"""
import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--rounds", type=int, default=11)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_qsgd_round: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs.fedar_mnist import MnistConfig, fleet_fed
    from repro_torch.core.fedar import FedARServer
    from repro_torch.core.resources import TaskRequirement
    from repro_torch.data.federated import scaled_fleet
    from repro_torch.data.synthetic import make_digits

    import repro_torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; repro_torch from {Path(repro_torch.__file__).parent}")
    dev = torch.device("cuda")
    fed = fleet_fed(512, aggregation="async", compress="qsgd", compress_bits=4,
                    defense="foolsgold_sketch")
    force = torch.as_tensor(np.arange(512) % 10 == 0, device=dev)
    server = FedARServer(MnistConfig(), fed, TaskRequirement(), device=dev)
    data = server.engine.device_data(scaled_fleet(512, samples_per_client=200))
    eval_set = make_digits(500, seed=99)
    walls = []
    for _ in range(args.rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.run_round(data, eval_set=eval_set, force_straggler=force)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if not torch.isfinite(server.state.params).all():
        raise AssertionError("non-finite params")

    draws, dim = server.engine.draws, server.engine.dim
    # the draw's signature: (round, n, d) before the uniforms were keyed by
    # client id, (round, ids, d) after
    if "ids" in inspect.signature(draws.uniform).parameters:
        rows = torch.arange(512, device=dev)
    else:
        rows = 512
    times = []
    for r in range(23):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        draws.uniform(r, rows, dim)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    steady = walls[1:]
    print(json.dumps(dict(
        label=args.label, card=smi, rounds=args.rounds,
        steady_rounds_per_s=(len(steady)) / sum(steady),
        round_ms_median=1e3 * float(np.median(steady)),
        round_ms=[round(1e3 * w, 3) for w in walls],
        uniform_ms_median=float(np.median(times[3:])),
        uniform_shape=[512, dim])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
