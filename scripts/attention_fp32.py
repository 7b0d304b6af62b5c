"""Kernel 8's fp32 instance at the shapes ``chip_smoke.py`` phase 2 times
it, for one copy of the port, on one card.

``--src`` names the ``src`` directory whose ``repro_torch`` is imported, so
that a commit and its parent (each unpacked with ``git archive``) can be
timed on the same card in one session.  For each shape the script makes
q, k and v from a seeded generator on the card and prints one JSON line:
the SHA-256 digest of the output's bits and of a second launch's (equal
when the kernel is deterministic), the largest error / tolerance row by
row against the plain version (rtol 1e-4, as phase 2), the kernel's median
device ms (CUDA events over single launches), SDPA's on the same inputs
(``scaled_dot_product_attention`` in its (B, H, S, hd) layout, a band mask
for a window), the bound (the larger of bytes over 3.35 TB/s and fp32
FLOPs over 67 TFLOP/s), and, where the copy has them, the plan
(``fp32_plan``) and the instances' resources (``fp32_attrs``).

``--split`` instead copies the package into ``src/repro_torch/_build/
attn_split/`` (git ignores it), puts ``clock64`` stamps at the fp32
kernel's ``// [split]`` marks (thread 0 of every block adds the cycles of
each phase of each key tile), builds that copy and prints, for each shape,
the mean microseconds of a key tile by phase, as thread 0 sees it: the
K copy's wait and the first barrier, the scores (V's copy queued among
them), the softmax, the V copy's wait and the second barrier, and P V
(the next K's copy queued among it).  A phase holds whatever the other
warps on thread 0's scheduler issue meanwhile.  The stamps cost a few
percent; compare splits, not times, with other runs.

Run:  python scripts/attention_fp32.py --src src --label change
      python scripts/attention_fp32.py --src src --split
"""
import argparse
import hashlib
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

# (label, B, S, H, K, hd, window): chip_smoke.py phase 2's fp32 cases,
# under its labels (minicpm3-4b's v is 64 columns, zero-padded to 96)
SHAPES = [
    ("zamba2-7b", 4, 2048, 32, 32, 112, 0),
    ("zamba2-7b, window 512", 4, 2048, 32, 32, 112, 512),
    ("tinyllama-1.1b", 1, 2048, 32, 4, 64, 0),
    ("gemma3-1b, local, route check", 1, 1024, 4, 1, 256, 512),
    ("gemma3-1b, global, route check", 1, 1024, 4, 1, 256, 0),
    ("gemma3-1b, local, ragged S", 1, 1000, 4, 1, 256, 512),
    ("qwen2-moe-a2.7b", 4, 2048, 16, 16, 128, 0),
    ("minicpm3-4b, MLA", 4, 2048, 40, 40, 96, 0),
    ("internvl2-1b, 256 patches + 1,792 text", 4, 2048, 14, 2, 64, 0),
    ("musicgen-medium", 4, 2048, 24, 24, 64, 0),
    ("internvl2-1b, route check", 1, 1024, 14, 2, 64, 0),
    ("head dim 61", 2, 1000, 8, 2, 61, 0),
]
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PHASES = ["K wait", "scores", "softmax", "V wait", "P V"]
NP = len(PHASES)


def bound_ms(B, S, H, K, hd, window, dv):
    w = window or S
    live = w * (w + 1) // 2 + (S - w) * w if S > w else S * (S + 1) // 2
    nbytes = 4 * B * S * (H + K) * (hd + dv)
    flops = 2 * B * H * (hd + dv) * live
    return max(nbytes / PEAK_BYTES, flops / PEAK_FP32) * 1e3


def stamped_copy(src: Path) -> Path:
    """The package copy with the stamps; returns the directory to import."""
    root = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "_build" / "attn_split"
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(src / "repro_torch", root / "repro_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = root / "repro_torch" / "csrc" / "flash_attention.cu"
    s = cu.read_text()
    marks = {f"// [split] {name}": i for i, name in enumerate(PHASES)}
    for mark, i in marks.items():
        if s.count(mark) != 1:
            raise RuntimeError(f"the fp32 kernel has no single mark {mark!r}")
        tile = f" split_s[{NP}] += 1;" if i == NP - 1 else ""
        s = s.replace(mark, "if (threadIdx.x == 0) { long long n = clock64(); "
                      f"split_s[{i}] += n - split_t; split_t = n;{tile} }}")
    s = s.replace("// [split] start", (
        f"long long split_s[{NP + 1}] = {{}};\n"
        "  long long split_t = clock64(), split_c0 = split_t;\n"
        "  unsigned long long split_g0 = 0;\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(split_g0));"), 1)
    s = s.replace("// [split] end", (
        "if (threadIdx.x == 0) {\n"
        "    unsigned long long g1;\n"
        "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
        f"    for (int i = 0; i <= {NP}; ++i)\n"
        "      atomicAdd(&fedar_attn_split_cycles[i], (unsigned long long)split_s[i]);\n"
        f"    atomicAdd(&fedar_attn_split_cycles[{NP + 1}],\n"
        "              (unsigned long long)(clock64() - split_c0));\n"
        f"    atomicAdd(&fedar_attn_split_cycles[{NP + 2}], g1 - split_g0);\n"
        "  }"), 1)
    anchor = "// ----------------------------------------------------------------- fp32\n"
    s = s.replace(anchor, anchor + "__device__ unsigned long long "
                  f"fedar_attn_split_cycles[{NP + 3}];\n", 1)
    s += ('\nextern "C" int fedar_attn_split(unsigned long long* out, int reset) {\n'
          f"  unsigned long long z[{NP + 3}] = {{}};\n"
          "  if (reset) return (int)cudaMemcpyToSymbol(fedar_attn_split_cycles, z, sizeof(z));\n"
          "  return (int)cudaMemcpyFromSymbol(out, fedar_attn_split_cycles, sizeof(z));\n}\n")
    cu.write_text(s)
    return root


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--only", default="", help="comma-separated indices into SHAPES")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("attention_fp32: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(stamped_copy(src) if args.split else src))
    import ctypes

    from repro_torch.kernels import flash_attention as mod
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = ops.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    head = dict(label=args.label, src=str(src), card=smi)
    if hasattr(mod, "fp32_attrs"):
        head["attrs"] = mod.fp32_attrs()
    print(json.dumps(head))
    if args.split:
        lib.fedar_attn_split.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda")
    shapes = [SHAPES[int(i)] for i in args.only.split(",")] if args.only else SHAPES
    for n, (label, B, S, H, K, hd, window) in enumerate(shapes):
        gen = torch.Generator(device=dev).manual_seed(n)
        q, k = (torch.randn(B, S, h, hd, generator=gen, device=dev) for h in (H, K))
        dv = 64 if "MLA" in label else hd
        v_own = torch.randn(B, S, K, dv, generator=gen, device=dev)
        v = torch.nn.functional.pad(v_own, (0, hd - dv))
        run = lambda: mod.flash_attention(q, k, v, causal=True, window=window)  # noqa: E731
        if args.split:
            run()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (NP + 3))()
            ops.check_launch(lib.fedar_attn_split(None, 1), "attn_split")
            run()
            torch.cuda.synchronize()
            ops.check_launch(lib.fedar_attn_split(ctypes.addressof(buf), 0), "attn_split")
            vals = list(buf)
            tiles, ghz = vals[NP], vals[NP + 1] / max(vals[NP + 2], 1)
            us = lambda c: round(c / tiles / ghz / 1e3, 4)  # noqa: E731
            print(json.dumps(dict(label=label, shape=[B, S, H, K, hd], window=window,
                                  key_tiles=tiles, sm_ghz=round(ghz, 3),
                                  us_a_tile=us(sum(vals[:NP])),
                                  split_us={p: us(vals[i]) for i, p in enumerate(PHASES)})))
            continue
        out = run()
        again = run()
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        err = (out - want).abs()
        worst = (err / (1e-4 * want.abs().amax(-1, keepdim=True)).clamp_min(1e-30)).max().item()
        del want

        def timed(fn):
            fn()
            times = []
            for _ in range(args.reps):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b))
            return statistics.median(times)

        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v_own))
        band = None
        if window:
            i = torch.arange(S, device=dev)
            band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=band, is_causal=band is None, enable_gqa=K != H)
        line = dict(label=label, shape=[B, S, H, K, hd], window=window, digest=digest(out),
                    digest_again=digest(again), error_over_tolerance=round(worst, 4),
                    ms=round(timed(run), 4), sdpa_ms=round(timed(sdpa), 4),
                    bound_ms=round(bound_ms(B, S, H, K, hd, window, dv), 4))
        if hasattr(mod, "fp32_plan"):
            line["plan"] = mod.fp32_plan(B, S, H, K, hd, window,
                                         sms=torch.cuda.get_device_properties(0)
                                         .multi_processor_count)._asdict()
        print(json.dumps(line))
        del q, k, v, v_own, qt, kt, vt, out, again
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
