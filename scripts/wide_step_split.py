"""Where a step of kernels 1 and 4's wide instance goes, phase by phase, on
one card.

The script copies the ``repro_torch`` package found under ``--src`` into
``src/repro_torch/_build/step_split/`` (git ignores it), adds ``clock64``
stamps to the copy's wide kernel (thread 0 of every CTA adds the cycles of
each phase of each step into shared memory and, at the end, into a device
array) and a C entry that reads them, builds that copy's kernels, runs
kernel 1 once on ``scripts/local_sgd_widths.py``'s inputs (I = 784, C = 10,
B = 20, E = 5, mixed activations) at each width of ``--widths`` for
``--clients`` clients, and prints one JSON line a width: the kernel's ms
(CUDA events, stamps included), the SM clock (cycles over ``%globaltimer``
ns), the mean us of a step over every CTA's steps and its split by phase.
The stamps cost a few percent; compare splits, not times, with other runs.

Run:  python scripts/wide_step_split.py --src src --widths 512,813 --clients 512
"""
import argparse
import ctypes
import json
import shutil
import sys
from pathlib import Path

# (text in the kernel, stamp placed after it (True) or before it) for each
# phase end, in the order of a step
PHASES = [
    ("x wait", "    mbar_wait(smem_addr(&bars[cur]), (use >> 1) & 1);\n", True),
    ("first step's forward", "      prefetch_ring<kHS>(ring);\n    }\n    if (stager) {", False),
    ("stager and barrier", "    const int tn = s_next[cur];\n", True),
    ("softmax hidden layer", "    // --- logits: each CTA's h_slice", False),
    ("logits partials pushed", "      cluster.sync();\n      // every CTA has finished the previous step", False),
    ("logits cluster barrier", "      // every CTA has finished the previous step", False),
    ("d logits and barrier", "    // --- dh[:, slice] = d logits", False),
    ("dh, w2 gradient, barrier", "    if (soft) {\n      // softmax backward", False),
    ("softmax backward", "    // --- w2 and b1 updates", False),
    ("w2, b1, next x wait", "    if (fwd) mbar_wait(smem_addr(&bars[nxt]), ((use + 1) >> 1) & 1);\n", True),
    ("pass over w1", "    pass(true, fwd, xt, xs + nxt * kBT * I);\n", True),
    ("pass's last barrier", "    pass(true, fwd, xt, xs + nxt * kBT * I);\n    STAMP10\n    __syncthreads();\n", True),
    ("meet and prefetch", "    if (fwd) {\n      meet();\n      prefetch_ring<kHS>(ring);\n    }\n", True),
]
NP = len(PHASES)


def stamped_copy(src: Path) -> Path:
    """The package copy with the stamps; returns the directory to import."""
    root = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "_build" / "step_split"
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(src / "repro_torch", root / "repro_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    hdr = root / "repro_torch" / "csrc" / "local_sgd.cuh"
    s = hdr.read_text()
    k = s.index("local_sgd_wide_kernel(")
    head, body = s[:k], s[k:]
    head = head.replace(
        "template <bool kRagged, int kHS>\n__global__ void __launch_bounds__(kWideThreads, 1)\n",
        f"__device__ unsigned long long fedar_split[{NP + 3}];\n"
        "template <bool kRagged, int kHS>\n__global__ void __launch_bounds__(kWideThreads, 1)\n")
    body = body.replace("  int use = 0, nred = 0;\n", (
        "  int use = 0, nred = 0;\n"
        f"  __shared__ long long split_s[{NP + 3}];\n"
        f"  if (threadIdx.x == 0) for (int i = 0; i < {NP + 3}; ++i) split_s[i] = 0;\n"
        "  long long split_t = clock64(), split_c0 = split_t;\n"
        "  unsigned long long split_g0 = 0;\n"
        "  if (threadIdx.x == 0) asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(split_g0));\n"), 1)
    for i, (_, anchor, after) in enumerate(PHASES):
        anchor = anchor.replace("STAMP10", "if (threadIdx.x == 0) { long long n = clock64(); "
                                "split_s[10] += n - split_t; split_t = n; }")
        stamp = (f"if (threadIdx.x == 0) {{ long long n = clock64(); split_s[{i}] += n - split_t; "
                 "split_t = n; }\n")
        if body.count(anchor) != 1:
            raise RuntimeError(f"the wide kernel has changed: no single place for {PHASES[i][0]!r}")
        body = body.replace(anchor, anchor + "    " + stamp if after else "    " + stamp + anchor)
    body = body.replace("    ++use;\n    t = tn;\n", (
        f"    ++use;\n    t = tn;\n    if (threadIdx.x == 0) split_s[{NP}] += 1;\n"), 1)
    body = body.replace("  asm volatile(\"cp.async.wait_all;\" ::: \"memory\");\n", (
        "  asm volatile(\"cp.async.wait_all;\" ::: \"memory\");\n"
        "  if (threadIdx.x == 0) {\n"
        "    unsigned long long g1;\n"
        "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
        f"    split_s[{NP + 1}] = clock64() - split_c0;\n"
        f"    split_s[{NP + 2}] = (long long)(g1 - split_g0);\n"
        f"    for (int i = 0; i < {NP + 3}; ++i)\n"
        "      atomicAdd(&fedar_split[i], (unsigned long long)split_s[i]);\n"
        "  }\n"), 1)
    hdr.write_text(head + body)
    tu = root / "repro_torch" / "csrc" / "local_sgd_wide.cu"
    tu.write_text(tu.read_text() + (
        '\nextern "C" int fedar_step_split(unsigned long long* out, int reset) {\n'
        f"  unsigned long long z[{NP + 3}] = {{}};\n"
        "  if (reset) return (int)cudaMemcpyToSymbol(fedar_split, z, sizeof(z));\n"
        "  return (int)cudaMemcpyFromSymbol(out, fedar_split, sizeof(z));\n}\n"))
    return root


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent / "src"))
    ap.add_argument("--widths", default="512,813")
    ap.add_argument("--clients", type=int, default=512)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("wide_step_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(stamped_copy(Path(args.src).resolve())))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from local_sgd_widths import inputs
    from repro_torch.kernels import local_sgd as mod
    from repro_torch.kernels import ops

    lib = ops.library()
    lib.fedar_step_split.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda")
    for H in (int(h) for h in args.widths.split(",")):
        g, x, y, act, mask = (torch.as_tensor(a, device=dev) for a in inputs(H, args.clients, 200))
        kw = dict(hidden=H, classes=10, lr=0.1, epochs=5, batch_size=20)
        mod.local_sgd(g, x, y, act, mask, **kw)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (NP + 3))()
        ops.check_launch(lib.fedar_step_split(None, 1), "step_split")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        mod.local_sgd(g, x, y, act, mask, **kw)
        end.record()
        torch.cuda.synchronize()
        ops.check_launch(lib.fedar_step_split(ctypes.addressof(buf), 0), "step_split")
        v = list(buf)
        steps, ghz = v[NP], v[NP + 1] / max(v[NP + 2], 1)
        us = lambda c: round(c / steps / ghz / 1e3, 3)  # noqa: E731
        print(json.dumps(dict(H=H, R=args.clients, plan=mod.plan(784, H, 10, 20)._asdict(),
                              ms=start.elapsed_time(end), sm_ghz=round(ghz, 3),
                              us_a_step=us(v[NP + 1]),
                              split_us={name: us(v[i]) for i, (name, _, _) in
                                        enumerate(PHASES)})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
