"""Kernels 1 and 4 (the fused local-SGD kernel, dense and ragged) at several
hidden widths and batch sizes, for one copy of the port, on one card.

``--src`` names the ``src`` directory whose ``repro_torch`` is imported, so
that a commit and its parent (each unpacked with ``git archive``) can be run
on the same card in one session.  For every width in ``--widths`` and batch
size in ``--batches`` (default 20) the script runs both forms on the same
numpy-seeded inputs (I = 784, C = 10, E = 5, mixed ReLU / softmax clients,
a ragged tail, an all-masked batch and an all-False client) and prints one
JSON line: the SHA-256 digest of each
form's output bits, the largest error against the plain version
(``kernels/ref.py``), the kernel's median device ms (CUDA events) and, where
the copy has it, the plan's cluster size, slice width, resources, the
clusters resident at once, whether w1 streams from L2 (``streamed``) and,
in a copy with the three instances, which one runs (``instance``).  A width the copy's kernel refuses prints
``refused`` with its message.  Two copies whose digests agree at a width run
that width bit for bit alike.  ``--f64`` also holds the kernel and the fp32
plain version against the plain version in float64, row by row: where the
two fp32 versions part, it shows which one left the float64 rows.
``--packed`` also times kernel 4 on the packed tile layout of the
quantity-skewed fleet (``make_federated("digits", 512,
scenario="quantity_skew", samples_per_client=200, seed=7)``, the layout
the engine builds for it) at each width, with the digest of its bits.

Run:  python scripts/local_sgd_widths.py --src src --label change
      python scripts/local_sgd_widths.py --src src --widths 128 --batches 40,50,200 \
          --clients 512
      python scripts/local_sgd_widths.py --src src --widths 512,813 --clients 512 --packed
"""
import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np


def inputs(H, R, n, seed=0, I=784, C=10):
    """The global row and an (R, n) fleet, from numpy."""
    rng = np.random.default_rng(seed)
    D = H + C + I * H + H * C
    g = (rng.standard_normal(D) * 0.05).astype(np.float32)
    x = rng.random((R, n, I), dtype=np.float32)
    y = rng.integers(0, C, (R, n)).astype(np.int32)
    act = (np.arange(R) % 2).astype(np.int32)
    mask = np.ones((R, n), bool)
    mask[1, n - 15:] = False  # a ragged tail
    mask[2, :] = False  # an all-False client
    mask[3, 20:40] = False  # an all-masked batch between live ones
    return g, x, y, act, mask


def ragged(x, y, mask, B):
    """The (T, B, I) tile buffer of the dense rectangle, client after client."""
    R, n, I = x.shape
    nb = -(-n // B)
    pad = nb * B - n
    xt = np.pad(x, ((0, 0), (0, pad), (0, 0))).reshape(R * nb, B, I)
    yt = np.pad(y, ((0, 0), (0, pad))).reshape(R * nb, B)
    mt = np.pad(mask, ((0, 0), (0, pad))).reshape(R * nb, B)
    counts = np.full(R, nb, np.int32)
    off = (np.arange(R) * nb).astype(np.int32)
    return xt, yt, mt, counts, off


def digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def device_ms(torch, fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def packed_layout(H, B):
    """The engine's packed tile layout of the quantity-skewed 512-client
    fleet (batches of B) for ``small_model(H)``, on the card."""
    from repro_torch.configs.fedar_mnist import fleet_fed, small_model
    from repro_torch.core.fedar import FedARServer
    from repro_torch.core.resources import TaskRequirement
    from repro_torch.data.datasets import make_federated

    skew = make_federated("digits", 512, scenario="quantity_skew", samples_per_client=200,
                          seed=7)
    server = FedARServer(small_model(H), fleet_fed(512, local_batch_size=B),
                         TaskRequirement(), device="cuda")
    return server.engine.prepare_data(skew, layout="packed")["packed"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--widths", default="8,16,32,64,128")
    ap.add_argument("--batches", default="20")
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--samples", type=int, default=200)
    ap.add_argument("--f64", action="store_true",
                    help="also measure both fp32 versions against a float64 plain version")
    ap.add_argument("--packed", action="store_true",
                    help="also time kernel 4 on the quantity-skewed fleet's packed layout")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("local_sgd_widths: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch
    from repro_torch.kernels import local_sgd as mod
    from repro_torch.kernels import ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; repro_torch from {Path(repro_torch.__file__).parent}")
    dev = torch.device("cuda")
    E, lr, C = 5, 0.1, 10
    shapes = [(int(h), int(b)) for h in args.widths.split(",")
              for b in args.batches.split(",")]
    for H, B in shapes:
        g, x, y, act, mask = (torch.as_tensor(a, device=dev)
                              for a in inputs(H, args.clients, args.samples))
        kw = dict(hidden=H, classes=C, lr=lr, epochs=E)
        try:
            dense = mod.local_sgd(g, x, y, act, mask, batch_size=B, **kw)
        except ValueError as err:
            print(json.dumps(dict(label=args.label, H=H, B=B, refused=str(err))))
            continue
        rag_args = [torch.as_tensor(a, device=dev) for a in
                    ragged(x.cpu().numpy(), y.cpu().numpy(), mask.cpu().numpy(), B)]
        xt, yt, mt, nb, off = rag_args
        rag = mod.local_sgd_ragged(g, xt, yt, mt, act, nb, off, **kw)
        plain = ref.local_sgd_ref(g, x, y, act, mask, batch_size=B, **kw)
        torch.cuda.synchronize()
        rec = dict(label=args.label, H=H, B=B, R=args.clients, n=args.samples,
                   dense=digest(dense), ragged=digest(rag),
                   dense_equals_ragged=bool(torch.equal(dense, rag)),
                   max_abs_err=(dense - plain).abs().max().item(),
                   max_abs_plain=plain.abs().max().item(),
                   all_false_unchanged=bool(torch.equal(dense[2], g)),
                   ms=device_ms(torch, lambda: mod.local_sgd(
                       g, x, y, act, mask, batch_size=B, **kw)))
        if args.f64:
            want = ref.local_sgd_ref(g.double(), x.double(), y, act, mask, batch_size=B,
                                     dtype=torch.float64, **kw)
            k_rows = (dense.double() - want).abs().amax(1)
            p_rows = (plain.double() - want).abs().amax(1)
            worst = int((dense - plain).abs().amax(1).argmax())
            rec.update(kernel_vs_f64=k_rows.max().item(), plain_vs_f64=p_rows.max().item(),
                       widest_part=dict(row=worst, act=int(act[worst]),
                                        kernel_vs_f64=k_rows[worst].item(),
                                        plain_vs_f64=p_rows[worst].item()))
        # a copy with the padded plan or with the three instances
        if hasattr(mod, "MAX_HIDDEN") or hasattr(mod, "INSTANCES"):
            rec.update(mod.kernel_attrs(784, H, C, B))
        if args.packed:
            lay = packed_layout(H, B)
            pargs = (lay.tiles["x"], lay.tiles["y"], lay.tile_mask, lay.act, lay.nb, lay.off)
            rec.update(packed_tiles=int(lay.tile_mask.shape[0]),
                       packed=digest(mod.local_sgd_ragged(g, *pargs, **kw)),
                       packed_ms=device_ms(torch, lambda: mod.local_sgd_ragged(g, *pargs, **kw)))
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
