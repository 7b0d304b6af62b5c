#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases (any failure raises and the script exits non-zero):

1. Environment: torch / CUDA versions, the card's name and power limit, the
   build of the CUDA kernels from ``src/repro_torch/csrc`` (set-up time).
2. Each kernel against its plain PyTorch version on the card, at the shapes
   of the main path: max error against the stated tolerance, kernel ms
   (CUDA events, median of repeats), plain ms, the one-call PyTorch
   yardstick where there is one (``library_ms``, timed here only), and the
   bound (bytes or FLOPs at the H100 SXM data-sheet rates).
3. The main path: ``FedARServer`` on the paper's 12-robot Table II fleet at
   full width (784 -> 128 -> 10), 5 rounds of fedar + foolsgold_sketch with
   a 500-sample eval set.  Every kernel's launch count must be > 0.  The
   same run on the plain route must give identical trust and masks and
   params within tolerance.
4. Scale: a 512-client tiled fleet (200 samples each), 6 rounds (round 1
   is warm-up), with the same launch-count check; each round is held
   against one plain-route round from the same state, and ``local_sgd``
   against its plain version at this path's shape.
5. Buffered async with 4-bit QSGD at full width, 512 clients: the same
   fleet, ``aggregation="async"``, ``compress="qsgd"``, ``compress_bits=4``,
   foolsgold_sketch, every 10th client forced to straggle; 6 rounds (round
   1 warm-up).  ``local_sgd``, ``fedavg_agg``, ``sketch_similarity``,
   ``pack_codes`` and ``unpack_codes`` must each launch; each round is then
   run again from the same state on the kernel route and with
   ``compress_impl="einsum"``, and every carried tensor must be identical
   (every op of the round adds in a fixed order, the count sketch included).
6. Top-k at full width, 12 robots: the Table II fleet, fedar + ``compress=
   "topk"`` (k = D // 32 = 3180); ``topk_decode`` must launch, and the same
   route check.  Then phase 4's 512-client fleet with the same top-k, 6
   rounds (round 1 warm-up): ``topk_decode`` must launch twice a round
   (the residual's decode in ``encode`` and the server's), the state must
   stay finite, and the route check.
7. Gated packed at full width, 512 clients: a quantity-skewed digits fleet
   (``make_federated("digits", 512, scenario="quantity_skew", seed=7)``,
   1-1394 samples per client), ``prepare_data`` picks the packed layout,
   fedar + foolsgold_sketch with ``select_frac=0.5``, 6 rounds (round 1
   warm-up).  ``local_sgd_ragged``, ``fedavg_agg`` and ``sketch_similarity``
   must each launch once a round and ``local_sgd`` never.  Each round is
   held against one plain-route round from the same state, and against the
   dense, ungated kernel route from the same state (trust and masks
   identical, params within 1e-5).  The dense ungated run is timed in the
   same call.
8. Drift on the packed layout: a 64-client ``robot_drift`` fleet (4
   windows) forced onto the packed layout, fedar + foolsgold_sketch, 4
   rounds so that every window trains; ``local_sgd_ragged`` must launch,
   and the plain-route check of phase 4.

9. Serving prefill on zamba2-7b at full width and depth (81 Mamba2 layers,
   the shared attention block after every 6th: 13 applications), bf16,
   params from ``Model.init_params`` on a seeded CUDA generator: 4 requests
   of 4 prompts x 2,048 tokens and one of 1 x 8,192 (the first is warm-up),
   each returning next-token logits and the greedy token.  Each request must
   launch ``flash_attention`` 13 times and ``ssm_scan`` 81 times.  One
   request of each shape runs again under ``torch.profiler`` for each
   kernel's device ms per request and the device idle share.  Then, in
   fp32 at the same width (27 GB, after phase 9b's bf16 runs free the bf16
   model), one 1 x 1,024 request through the kernel route and the plain
   route (``attn_impl = ssm_impl = "einsum"``) from the same params, block
   by block: each block within tolerance and the same greedy token.

9b. Serving decode (``Model.init_cache`` / ``decode_step``, plain PyTorch,
   as ``examples/serve_decode.py`` runs it): on phase 9's bf16 params, B = 4
   then B = 1, each a 512-token prompt stepped through a fresh cache and 128
   greedy tokens after 8 warm-up steps; then tinyllama-1.1b at full width
   (32 heads over 4 kv heads), B = 4.  Each run prints ms a step (host
   clock, one sync at the end), generated tokens/s, launches a step and the
   device idle share (``torch.profiler`` over 4 more steps), peak memory,
   cache bytes and the step's bytes bound; no kernel may launch, the
   logits must stay finite and the tokens in the vocabulary.  After phase
   9's route check, on its fp32 model, and on tinyllama-1.1b in fp32 (also
   with a 128-slot ring that wraps): every block's plain forward over 2 x
   256 positions against its decode stepped from an empty cache, row by
   row, and each Mamba2 layer's final state against ``ssd_chunked``'s.

10. The host-store cohort engine (``CohortEngine`` through ``FedARServer``)
   with chaos faults, at full width.  10a: ``VirtualFleet(1_000_000)``, K =
   256, fedar + foolsgold_sketch, 6 rounds (round 1 warm-up), a 1.07 GB
   host store.  10b: ``VirtualFleet(10_000)``, K = 256, async + 4-bit QSGD,
   6 rounds, 8.14 GB of residual and pending columns on the host.  Each
   prints rounds/s, the round's wall time by part (``CohortEngine.
   timings``), the fault slots (crashed, corrupted, unavailable,
   quarantined) and the kernel launches of every round.  Every round of 10a
   and rounds 1-2 of 10b are held against the plain route (``*_impl=
   "einsum"``) from the same store and params: cohort, trust, masks and
   bookkeeping columns identical, params within 2e-4, the cohort's history
   rows within phase 4's kink bound (10b: residual, pending and history up
   to QSGD code flips).  10b saves the store after round 3 and resumes it
   in a fresh engine: rounds 4-6 must end bit-equal to the uninterrupted
   run.  ``local_sgd`` is held against its plain version at R = 256.
11. Federated LM training (``LMClientModel`` through ``FedARServer``) at
   full width: tinyllama-1.1b (22 layers, d_model 2,048, 32 heads over 4
   kv heads, d_ff 5,632, vocab 32,000; bf16 weights, fp32 norms; params
   from ``LMClientModel.init`` on a seeded CUDA generator), ``fleet_fed(4)``
   with fedar + foolsgold_sketch, E = 2, B = 8, lr 0.05, on the
   ``federated_lm_corpus`` of ``examples/federated_lm.py`` at 4 clients;
   the timeout is set from the fleet's own latencies.  4 rounds (round 1
   warm-up), each printing its wall seconds by part (client training, the
   sketch, aggregation, the eval, the rest), training tokens/s, launches,
   held-out loss and token accuracy and peak memory; ``fedavg_agg``,
   ``sketch_similarity`` and ``count_sketch`` must launch once a round and
   ``flash_attention`` 22 times (the eval's forward); rounds 2-4 are each
   held against a plain-route round (``agg_impl = defense_impl =
   "einsum"``) from the same state.  One more round runs under
   ``torch.profiler`` for the device's idle share.  Then the count sketch
   at the path's (4, D) (bit-equal over ten runs), ``fedavg_agg`` at (4, D)
   (N x D past 2^31) and ``sketch_similarity`` at 4 x 256; then the
   example's reduced fleet (2 layers, d_model 128, 8 clients, 8 rounds),
   async + foolsgold_sketch and fedavg + none, with the same route check.

Phase 2 also prints the local-SGD kernel's cluster size, shared bytes and
registers, and each local-SGD case's chain floor beside its bound (the
longest client's steps on its cluster's SMs at their share of the fp32
peak).  It holds ``local_sgd_ragged`` on phase 7's tile buffer against its
plain version and, bit for bit, against ``local_sgd`` on the fleet's dense
(N, n_max) rectangle; and ``flash_attention`` and ``ssm_scan`` against
their plain versions at phase 9's shapes, in bf16 and fp32 (the 1 x 8,192
prompt in bf16; the fp32 scan row by row against the float64 recurrence),
with each bf16 instance's registers and shared bytes; and the defense's
count sketch (``count_sketch``, a CUDA kernel that sums in a fixed order;
no TPU kernel) against the reference's scatter-add, run ten times on the
same rows, where it must give one result.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits non-zero and prints no result.  ``--profile DIR`` also writes a
``torch.profiler`` table of one round of phases 3, 4, 5, 6 (both fleets,
with a compressed round's device time split into ``torch.topk``, the
gather, the two decodes, ``local_sgd`` and the rest), 7 (both layouts) and
8, of each profiled request of phase 9 and of each decode run's profiled
steps of phase 9b.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
DEV = "cuda"

# H100 SXM data sheet: HBM3 bandwidth, fp32 (non-tensor-core) peak, dense
# bf16 tensor-core peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12


def bound_ms(nbytes: float, flops: float,
             peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of one ``fn()`` call over ``reps`` calls, after
    warm-up.  Each timed call is queued behind a spin kernel
    (``torch.cuda._sleep``) that outlasts the host's enqueueing, so the CUDA
    events bracket device work only and not Python's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    spin_cycles = int(max(3.0 * host_s, 1e-3) * 2.0e9)  # ~2 GHz SM clock
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, got, want, *, atol, rtol):
    err = (got - want).abs().max().item()
    limit = atol + rtol * want.abs().max().item()
    ok = err <= limit
    print(f"  {name}: max_abs_err={err:.3e} (tolerance {limit:.3e}: "
          f"atol={atol:g} + rtol={rtol:g} * max|plain|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


# At 512 clients a few rows of a 50-step local SGD differ between any two
# fp32 implementations by far more than the rest: a ReLU pre-activation
# within rounding of 0 takes the other branch in one of them, and the step
# moves that row by ~1e-4; the two plain versions, ref.local_sgd_ref and
# autograd, differ from each other the same way on the same inputs (phase 4
# prints it).  Rows are held to the tight tolerance except at most 1% of
# them, which are held to a kink bound.
KINK_FRAC = 0.01


def compare_rows(name, got, want, *, atol, rtol, kink_atol):
    """Per-row comparison for (rows, cols) outputs of long SGD chains: all
    rows within ``atol + rtol * max|want|`` except at most ``KINK_FRAC`` of
    them, and every row within ``kink_atol``.  Returns the max error."""
    row_err = (got - want).abs().amax(dim=1)
    err = row_err.max().item()
    limit = atol + rtol * want.abs().max().item()
    over = int((row_err > limit).sum().item())
    allowed = int(KINK_FRAC * got.shape[0])
    ok = over <= allowed and err <= kink_atol
    print(f"  {name}: max_abs_err={err:.3e}, {over} of {got.shape[0]} rows over "
          f"{limit:.3e} (atol={atol:g} + rtol={rtol:g} * max|plain|; at most "
          f"{allowed} may be, each within {kink_atol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def sgd_flops(mask, B, I, H, C, epochs):
    """FLOPs of the local-SGD work this data needs: the two B x I x H
    products (forward, w1 gradient) and three B x H x C ones, for every
    batch with at least one real sample."""
    R, n = mask.shape
    nb = -(-n // B)
    padded = torch.nn.functional.pad(mask.to(torch.float32), (0, nb * B - n))
    live = int((padded.reshape(R, nb, B).sum(-1) > 0).sum().item())
    return live * epochs * (4 * B * I * H + 6 * B * H * C)


def chain_floor_ms(steps: int, B, I, H, C, K) -> float:
    """The local-SGD kernel's chain floor: the longest client's live steps,
    each ``4*B*I*H + 6*B*H*C`` FLOPs, on the K SMs of its cluster at their
    share of the fp32 peak (K x 67/132 TFLOP/s)."""
    return steps * (4 * B * I * H + 6 * B * H * C) / (K * PEAK_FP32_FLOPS / 132) * 1e3


def sgd_resources(I, H, C, B) -> str:
    """Phase 2's line on the local-SGD kernel's cluster and resources."""
    from repro_torch.kernels.local_sgd import kernel_attrs

    a = kernel_attrs(I, H, C, B)
    return (f"cluster of K = {a['cluster']} CTAs of {a['threads']} threads, "
            f"{a['dynamic_smem']} dynamic shared bytes a CTA, {a['registers']} "
            f"registers and {a['local_bytes']} spilled bytes a thread, "
            f"{a['max_clusters']} clusters on the card at once")


def large_tile_ms(a):
    """Device ms of the similarity kernel's 32 x 64 tile plan on a 12-row
    Gram product, through the C entry with ``small = 0`` (not counted as a
    launch).  At 12 x 12 either tile covers the output in one block, so the
    wrapper's K split is the same for both."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.defense_sim import split_chunk

    M, K = a.shape
    chunk = split_chunk(M, M, K)
    splits = -(-K // chunk)
    out = torch.empty(M, M, device=a.device)
    part = torch.empty(splits, M, M, device=a.device) if splits > 1 else None
    lib = ops.library()

    def run():
        ops.check_launch(lib.fedar_sketch_similarity(
            a.data_ptr(), a.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), M, M, K, chunk, 0,
            ops.stream_ptr(a)), "sketch_similarity")

    run()
    compare("  the 32 x 64 tile alone", out, ref.sketch_similarity_ref(a, a), atol=1e-5,
            rtol=0.0)
    return time_ms(run, reps=20)


def order_cost(mask, B: int, calls: int = 100) -> str:
    """What the wrapper's cluster order costs a call: ``longest_first`` of
    ``live_batches`` on the padded float32 mask, as ``local_sgd`` computes
    it, in device time and in host time to enqueue (mean of ``calls``)."""
    from repro_torch.kernels.local_sgd import live_batches, longest_first

    m = mask.to(torch.float32)

    def run():
        return longest_first(live_batches(m, B))

    dev_ms = time_ms(run, reps=20)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        run()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return (f"cluster order (longest_first of live_batches): {dev_ms:.4f} ms on the "
            f"device, {host_us:.1f} us of host time a call")


def kernel_phase(ref, kernels, fleet):
    """Phase 2: each kernel vs its plain version at the main path's shapes.
    Returns the per-kernel JSON entries (main-path case of each)."""
    from repro_torch.kernels.local_sgd import live_batches, plan

    local_sgd, fedavg_agg, sketch_similarity = kernels
    gen = torch.Generator().manual_seed(0)
    dev = DEV
    entries = {}

    # --- kernel 1: local_sgd at the 12-robot fleet (R=12, n=1000)
    I, H, C, B, E, lr = 784, 128, 10, 20, 5, 0.1
    D = H + C + I * H + H * C
    g = (torch.randn(D, generator=gen) * 0.05).to(dev)
    x = torch.as_tensor(fleet["x"], device=dev)
    y = torch.as_tensor(fleet["y"], device=dev)
    act = torch.as_tensor(fleet["activations"], device=dev)
    R, n = y.shape
    cases = [("12 clients, n=1000, mixed activations",
              x, y, torch.ones(R, n, dtype=torch.bool, device=dev))]
    # ragged n = 990 under a mask, one all-padding batch, one all-False client
    m = torch.ones(R, 990, dtype=torch.bool, device=dev)
    m[0, 975:] = False
    m[2, 100:120] = False
    m[3, :] = False
    cases.append(("12 clients, ragged n=990, all-padding batch, all-False client",
                  x[:, :990].contiguous(), y[:, :990].contiguous(), m))
    print("local_sgd (tolerance: fp32 sums in another order over up to 250 "
          "sequential SGD steps)")
    for label, xc, yc, mc in cases:
        def run_kernel():
            return local_sgd(g, xc, yc, act, mc, hidden=H, classes=C, lr=lr,
                             batch_size=B, epochs=E)

        def run_plain():
            return ref.local_sgd_ref(g, xc, yc, act, mc, hidden=H, classes=C,
                                     lr=lr, batch_size=B, epochs=E)
        got, want = run_kernel(), run_plain()
        torch.cuda.synchronize()
        err = compare(label, got, want, atol=1e-4, rtol=1e-4)
        if not mc.all():
            if not torch.equal(got[3], g):
                raise AssertionError("all-False client's params moved")
            print("  all-False client: output == input exactly")
        if "mixed" in label:
            k_ms = time_ms(run_kernel, reps=5)
            p_ms = time_ms(run_plain, reps=3)
            nbytes = 4 * (xc.numel() + yc.numel() + mc.numel() + D + R * D + R)
            b_ms, b_by = bound_ms(nbytes, sgd_flops(mc, B, I, H, C, E))
            K = plan(I, H, C, B)[0]
            steps = E * int(live_batches(mc, B).max())
            print(f"  kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
                  f"{b_ms:.3g} ms ({b_by}); chain floor {chain_floor_ms(steps, B, I, H, C, K):.3g} "
                  f"ms (the longest client's {steps} steps on its {K} SMs)")
            print(f"  {sgd_resources(I, H, C, B)}")
            print(f"  {order_cost(mc, B)}")
            entries["local_sgd"] = dict(
                name="local_sgd", route="cuda",
                source="src/repro_torch/csrc/local_sgd.cu",
                replaces="src/repro/kernels/local_sgd.py:148",
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)

    # --- kernel 2: fedavg_agg, D = 101,770 (H = 128)
    print("fedavg_agg (tolerance: fp32 sums over N clients in another order)")
    for N, stale in ((12, False), (12, True), (512, False), (512, True)):
        deltas = (torch.randn(N, D, generator=gen) * 0.01).to(dev)
        w = torch.rand(N, generator=gen).to(dev)
        tau = (torch.randint(0, 4, (N,), generator=gen).to(torch.float32).to(dev)
               if stale else None)
        got = fedavg_agg(deltas, w, staleness=tau)
        want = ref.fedavg_agg_ref(deltas, w, tau)
        err = compare(f"N={N}, staleness={'yes' if stale else 'no'}", got, want,
                      atol=1e-6, rtol=1e-5)
        k_ms = time_ms(lambda: fedavg_agg(deltas, w, staleness=tau), reps=20)
        p_ms = time_ms(lambda: ref.fedavg_agg_ref(deltas, w, tau), reps=20)
        lib_ms = (None if stale else
                  time_ms(lambda: torch.matmul(w, deltas), reps=20))
        nbytes = 4 * (N * D + N * (2 if stale else 1) + D)
        b_ms, b_by = bound_ms(nbytes, 2 * N * D)
        print(f"    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
              f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
              f"{b_ms:.3g} ms ({b_by})")
        if N == 12 and not stale:
            entries["fedavg_agg"] = dict(
                name="fedavg_agg", route="cuda",
                source="src/repro_torch/csrc/fedavg_agg.cu",
                replaces="src/repro/kernels/fedavg_agg.py:45",
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)

    # --- kernel 3: sketch_similarity on unit rows (the defense's input).
    # The path calls it as sketch_similarity(unit, unit) (core/foolsgold.py),
    # a Gram product, so its one (M, K) operand is read once: the bytes
    # bound counts M*K in and M*M out.
    print("sketch_similarity (tolerance: fp32 dot products of unit rows "
          "summed in another order)")
    for M, K in ((12, 256), (512, 256), (12, D)):
        a = torch.randn(M, K, generator=gen).to(dev)
        a = a / torch.linalg.vector_norm(a, dim=1, keepdim=True)
        got = sketch_similarity(a, a)
        want = ref.sketch_similarity_ref(a, a)
        err = compare(f"{M}x{K}", got, want, atol=1e-5, rtol=0.0)
        k_ms = time_ms(lambda: sketch_similarity(a, a), reps=20)
        p_ms = time_ms(lambda: ref.sketch_similarity_ref(a, a), reps=20)
        lib_ms = time_ms(lambda: torch.matmul(a, a.T), reps=20)
        b_ms, b_by = bound_ms(4 * (M * K + M * M), 2 * M * M * K)
        print(f"    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {b_ms:.3g} ms ({b_by})")
        if M == 12:
            print(f"    the 32 x 64 tile alone: {large_tile_ms(a):.4f} ms (why small "
                  "outputs take 16 x 16 tiles)")
        if M == 12 and K == 256:
            entries["sketch_similarity"] = dict(
                name="sketch_similarity", route="cuda",
                source="src/repro_torch/csrc/defense_sim.cu",
                replaces="src/repro/kernels/defense_sim.py:68",
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)
    entries["count_sketch"] = count_sketch_phase(gen, D)
    return entries


def sketch_bound(n: int, D: int, r: int, ent, start) -> tuple:
    """The count sketch's bound: the rows read once, the tables once, the
    (n, r) output written once; one add a coordinate of each row."""
    nbytes = 4 * n * D + ent.numel() * ent.element_size() \
        + start.numel() * start.element_size() + 4 * n * r
    return bound_ms(nbytes, n * D)


def sketch_f64(rows, bucket, sign, r: int, step: int = 1 << 27):
    """The count sketch summed in float64 (a slice of D at a time), the
    yardstick both fp32 versions are held to."""
    out = torch.zeros((rows.shape[0], r), dtype=torch.float64, device=rows.device)
    for d0 in range(0, rows.shape[1], step):
        sl = slice(d0, d0 + step)
        out.index_add_(1, bucket[sl], rows[:, sl].double() * sign[sl].double())
    return out


def count_sketch_check(sk, rows, label: str, reps: int = 20) -> dict:
    """The count sketch kernel on ``rows`` against its plain version (the
    reference's scatter-add, ``index_add_``, from the decoded tables),
    timed against it, and run ten times on the same rows to count the
    distinct results: the kernel must give one (a scatter-add's order
    varies on the card).  Both fp32 versions are held to the float64 sums:
    the kernel within 1e-6 + 1e-5 of their largest value, or, where
    ~4e6 terms a bucket round further than that (D = 1.1e9), within the
    plain version's own distance from them.  Returns the kernel's JSON
    fields at this shape."""
    from repro_torch.kernels.count_sketch import count_sketch, count_sketch_ref

    n, D = rows.shape
    bucket, sign = sk.bucket, sk.sign
    got = sk.sketch(rows)
    want = count_sketch_ref(rows, bucket, sign, sk.r)
    exact = sketch_f64(rows, bucket, sign, sk.r)
    err = (got - want).abs().max().item()
    k64 = (got.double() - exact).abs().max().item()
    p64 = (want.double() - exact).abs().max().item()
    limit = max(p64, 1e-6 + 1e-5 * exact.abs().max().item())
    ok = k64 <= limit
    print(f"  {label}: kernel vs index_add_ max_abs_err={err:.3e}; against the float64 "
          f"sums kernel {k64:.3e}, index_add_ {p64:.3e} (tolerance {limit:.3e}: the "
          f"larger of 1e-6 + 1e-5 * max|float64| and index_add_'s own) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the count sketch is farther from the float64 "
                             "sums than its tolerance")
    del exact

    def distinct(fn) -> int:
        return len({fn().cpu().numpy().tobytes() for _ in range(10)})

    ours = distinct(lambda: sk.sketch(rows))
    theirs = distinct(lambda: count_sketch_ref(rows, bucket, sign, sk.r))
    k_ms = time_ms(lambda: count_sketch(rows, *sk.tables), reps=reps)
    p_ms = time_ms(lambda: count_sketch_ref(rows, bucket, sign, sk.r), reps=reps)
    signed = rows * sign
    lib_ms = time_ms(lambda: torch.zeros(n, sk.r, device=DEV).index_add_(1, bucket, signed),
                     reps=reps)
    del signed
    b_ms, b_by = sketch_bound(n, D, sk.r, *sk.tables)
    print(f"    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, index_add_ alone {lib_ms:.4f} ms, "
          f"bound {b_ms:.4g} ms ({b_by}); distinct results in 10 runs: {ours} and {theirs}")
    if ours != 1:
        raise AssertionError("the count sketch differs between runs on the same rows")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def count_sketch_phase(gen, D: int) -> dict:
    """Phase 2, the defense's count sketch D -> 256 (no TPU kernel: the
    reference scatters) at the round's shapes.  Returns its JSON entry
    (N = 12)."""
    from repro_torch.common.config import FedConfig
    from repro_torch.core.defense import SketchedFoolsGold
    from repro_torch.kernels.count_sketch import sketch_plan

    sk = SketchedFoolsGold(FedConfig(defense="foolsgold_sketch"), D, DEV)
    kept = sum(t.numel() * t.element_size() for t in sk.tables)
    print(f"count_sketch D -> 256 (tolerance: fp32 sums in another order); tables "
          f"{kept / D:.3f} bytes a coordinate, {sketch_plan(D)[0]} segments")
    entry = None
    for n in (12, 256, 512):
        rows = (torch.randn(n, D, generator=gen) * 0.01).to(DEV)
        fields = count_sketch_check(sk, rows, f"N={n}")
        if n == 12:
            entry = dict(name="count_sketch", route="cuda",
                         source="src/repro_torch/csrc/count_sketch.cu",
                         replaces="src/repro/core/defense.py:135 (an XLA scatter, "
                                  "no Pallas kernel)", **fields)
    return entry


def ragged_phase(ref, local_sgd_ragged, local_sgd, packed, dense):
    """Phase 2, the ragged local-SGD kernel at phase 7's shapes: every row
    of the 512-client fleet's tile buffer (H = 128, B = 20, E = 5) against
    its plain version (phase 4's per-row rule), and bit-equal to the dense
    kernel on the fleet's (N, n_max) rectangle for the same clients and
    global row.  Returns the kernel's JSON entry."""
    from repro_torch.kernels.local_sgd import live_batches, plan

    H, C, E, lr = 128, 10, 5, 0.1
    xt, yt = packed.tiles["x"], packed.tiles["y"]
    T, B, I = xt.shape
    D = H + C + I * H + H * C
    g = (torch.randn(D, generator=torch.Generator().manual_seed(2)) * 0.05).to(DEV)
    args = (xt, yt, packed.tile_mask, packed.act, packed.nb, packed.off)
    kw = dict(hidden=H, classes=C, lr=lr, epochs=E)
    R = packed.act.shape[0]
    print(f"local_sgd_ragged ({R} clients, {T} tiles of B = {B}, batch counts "
          f"{sorted(set(packed.nb.tolist()))}; tolerance: fp32 sums in another "
          f"order over up to {E * int(packed.nb.max())} sequential SGD steps)")
    got = local_sgd_ragged(g, *args, **kw)
    want = ref.local_sgd_ragged_ref(g, *args, **kw)
    torch.cuda.synchronize()
    err = compare_rows("vs plain", got, want, atol=1e-4, rtol=1e-4, kink_atol=2e-3)
    rect = local_sgd(g, dense["x"], dense["y"], dense["activations"], dense["mask"],
                     batch_size=B, **kw)
    real = packed.valid  # fill rows (none at one shard) have no dense twin
    compare_exact(f"vs local_sgd on the dense ({dense['x'].shape[0]}, "
                  f"{dense['x'].shape[1]}) rectangle", got[real],
                  rect[packed.perm[real]])
    k_ms = time_ms(lambda: local_sgd_ragged(g, *args, **kw), reps=3)
    p_ms = time_ms(lambda: ref.local_sgd_ragged_ref(g, *args, **kw), reps=2)
    rect_args = (g, dense["x"], dense["y"], dense["activations"], dense["mask"])
    d_ms = time_ms(lambda: local_sgd(*rect_args, batch_size=B, **kw), reps=3)
    dp_ms = time_ms(lambda: ref.local_sgd_ref(*rect_args, batch_size=B, **kw), reps=2)
    b_ms, b_by = ragged_bound(packed, packed.tile_mask, None, D, H, C, E)
    K = plan(I, H, C, B)[0]
    steps = E * int(live_batches(dense["mask"], B).max())
    print(f"  kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.3g} ms "
          f"({b_by}); chain floor {chain_floor_ms(steps, B, I, H, C, K):.3g} ms (the "
          f"longest client's {steps} steps on its {K} SMs); local_sgd on the dense "
          f"rectangle {d_ms:.3f} ms (its plain version {dp_ms:.3f} ms)")
    # what the cluster order and the longest chain cost: the same launch
    # with the rows widest first (the wrapper sorts clusters longest first
    # itself, so the same time), and the longest row alone
    desc = packed.desc_rows
    order = (packed.act[desc], packed.nb[desc], packed.off[desc])
    o_ms = time_ms(lambda: local_sgd_ragged(g, *args[:3], *order, **kw), reps=3)
    top = desc[:1]
    one = (packed.act[top], packed.nb[top], packed.off[top])
    l_ms = time_ms(lambda: local_sgd_ragged(g, *args[:3], *one, **kw), reps=3)
    print(f"  the same rows widest first: {o_ms:.3f} ms; the longest client alone "
          f"({E * int(packed.nb[top])} steps): {l_ms:.3f} ms")
    return dict(name="local_sgd_ragged", route="cuda",
                source="src/repro_torch/csrc/local_sgd.cu",
                replaces="src/repro/kernels/local_sgd.py:243", max_abs_err=err,
                ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def ragged_bound(packed, tile_mask, rows, D, H, C, E):
    """The ragged kernel's bound for the clients ``rows`` (None: all): the
    bytes of their tiles, the global row, their output rows and row tables,
    and the FLOPs of their tiles with at least one real sample."""
    nb, off = packed.nb, packed.off
    if rows is not None:
        nb, off = nb[rows], off[rows]
    B, I = packed.tiles["x"].shape[1:]
    tiles = torch.cat([torch.arange(o, o + n) for o, n in zip(off.tolist(), nb.tolist())])
    R = nb.numel()
    nbytes = 4 * (tiles.numel() * B * (I + 2) + D * (1 + R) + 3 * R)
    # one (1, B) row per tile: sgd_flops counts the tiles with a real sample
    return bound_ms(nbytes, sgd_flops(tile_mask[tiles.to(DEV)], B, I, H, C, E))


def compare_exact(name, got, want):
    """Bit-equality of a kernel's output with its plain version."""
    ok = got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want)
    err = ((got.to(torch.float64) - want.to(torch.float64)).abs().max().item()
           if got.shape == want.shape and got.numel() else 0.0)
    print(f"  {name}: bit-equal {'ok' if ok else 'FAIL'} (max_abs_err={err:.3e})")
    if not ok:
        raise AssertionError(f"{name}: kernel output differs from its plain version")
    return err


def codec_phase(ref, codecs):
    """Phase 2, the uplink codecs: each kernel vs its plain version on the
    card, bit-equal, at the shapes of phases 5 (pack and unpack, N = 512) and
    6 (top-k decode, N = 12 and 512), plus N = 12 / 512 beside them, an odd
    D, duplicate indices and k = 0; top-k decode's launch plan and one
    launch a call.  Returns the JSON entries of the N = 512 shapes."""
    pack_codes, unpack_codes, topk_decode = codecs
    gen = torch.Generator().manual_seed(1)
    entries = {}
    D = 101770  # 784 -> 128 -> 10
    print("pack_codes / unpack_codes, 4 bits (integer ops: bit-equal)")
    for N, dim in ((12, D), (512, D), (12, D + 1), (512, D + 1)):
        codes = torch.randint(0, 15, (N, dim), generator=gen, dtype=torch.int32).to(DEV)
        packed = pack_codes(codes, bits=4)
        p_err = compare_exact(f"pack N={N}, D={dim}", packed,
                              ref.pack_codes_ref(codes, bits=4))
        back = unpack_codes(packed, bits=4, dim=dim)
        u_err = compare_exact(f"unpack N={N}, D={dim}", back,
                              ref.unpack_codes_ref(packed, bits=4, dim=dim))
        compare_exact(f"unpack(pack) N={N}, D={dim}", back, codes)
        P = packed.shape[1]
        nbytes = 4 * N * dim + N * P  # int32 codes one way, bytes the other
        b_ms, b_by = bound_ms(nbytes, 0)
        timings = {}
        for name, kern, plain in (
                ("pack_codes", lambda: pack_codes(codes, bits=4),
                 lambda: ref.pack_codes_ref(codes, bits=4)),
                ("unpack_codes", lambda: unpack_codes(packed, bits=4, dim=dim),
                 lambda: ref.unpack_codes_ref(packed, bits=4, dim=dim))):
            timings[name] = (time_ms(kern, reps=20), time_ms(plain, reps=20))
            print(f"    {name}: kernel {timings[name][0]:.4f} ms, plain "
                  f"{timings[name][1]:.4f} ms, bound {b_ms:.3g} ms ({b_by})")
        if N == 512 and dim == D:
            for name, line, err in (("pack_codes", 55, p_err), ("unpack_codes", 88, u_err)):
                entries[name] = dict(
                    name=name, route="cuda", source="src/repro_torch/csrc/compress.cu",
                    replaces=f"src/repro/kernels/compress.py:{line}",
                    max_abs_err=err, ms=timings[name][0], plain_ms=timings[name][1],
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)

    from repro_torch.kernels.compress import topk_decode_attrs, topk_plan

    print("topk_decode (distinct indices and pairs: bit-equal; triples: fp32 "
          "sums of three in another order, tolerance 1e-6 + 1e-6 * max|plain|)")
    k = D // 32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for N, dim in ((12, D), (512, D), (12, D + 1), (512, D + 1)):
        plan = topk_plan(N, k, dim, sms=sms)
        print(f"  plan N={N}, D={dim}: {plan}; on the card "
              f"{topk_decode_attrs(plan['smem_bytes'])}")
        vals = torch.randn(N, k, generator=gen).to(DEV)
        idx64 = torch.stack([torch.randperm(dim, generator=gen)[:k]
                             for _ in range(N)]).to(DEV)
        idx = idx64.to(torch.int32)
        before = topk_decode.launches
        err = compare_exact(f"N={N}, D={dim}, k={k}, distinct", topk_decode(vals, idx, dim),
                            ref.topk_decode_ref(vals, idx, dim))
        if topk_decode.launches != before + 1:
            raise AssertionError("topk_decode must launch its kernel once a call")
        pairs = torch.cat([idx[:, :k // 2], idx[:, :k - k // 2]], dim=1).contiguous()
        compare_exact(f"N={N}, D={dim}, k={k}, every index twice",
                      topk_decode(vals, pairs, dim), ref.topk_decode_ref(vals, pairs, dim))
        triples = torch.randint(0, k // 3, (N, k), generator=gen, dtype=torch.int32).to(DEV)
        compare(f"N={N}, D={dim}, k={k}, ~3 per index", topk_decode(vals, triples, dim),
                ref.topk_decode_ref(vals, triples, dim), atol=1e-6, rtol=1e-6)
        before = topk_decode.launches
        empty = torch.empty(N, 0, device=DEV)
        zero = topk_decode(empty, empty.to(torch.int32), dim)
        if topk_decode.launches != before or not torch.equal(
                zero, torch.zeros(N, dim, device=DEV)):
            raise AssertionError("topk_decode with k = 0 must give zeros without a launch")
        print(f"  N={N}, D={dim}, k=0: zeros, no launch ok")
        k_ms = time_ms(lambda: topk_decode(vals, idx, dim), reps=20)
        p_ms = time_ms(lambda: ref.topk_decode_ref(vals, idx, dim), reps=20)
        lib_ms = time_ms(lambda: torch.zeros(N, dim, device=DEV).scatter_add_(1, idx64, vals),
                         reps=20)
        # the writes alone: a fill of an output of the same size
        fill_ms = time_ms(lambda: torch.empty(N, dim, device=DEV).zero_(), reps=20)
        b_ms, b_by = bound_ms(4 * N * dim + 8 * N * k, 0)
        print(f"    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms (zeros + scatter_add_), bound {b_ms:.3g} ms ({b_by}), "
              f"{b_ms / k_ms:.0%} of it; a fill of the output {fill_ms:.4f} ms")
        if (N, dim) == (512, D):
            entries["topk_decode"] = dict(
                name="topk_decode", route="cuda", source="src/repro_torch/csrc/compress.cu",
                replaces="src/repro/kernels/compress.py:139", max_abs_err=err,
                ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return entries


def check_routes(server, plain, steps: int) -> None:
    """The kernel route against the plain route on the same data: trust and
    the selected / on-time masks identical, params and the defense history
    within the reference goldens' band."""
    for key in ("trust", "selected", "on_time"):
        if not np.array_equal(np.stack(server.history[key]),
                              np.stack(plain.history[key])):
            raise AssertionError(f"{key} differs between kernel and plain routes")
    print("  trust, selected and on-time masks: identical to the plain route")
    compare(f"params vs plain route (tolerance: fp32 sums in another order "
            f"over {steps} SGD steps)", server.state.params, plain.state.params,
            atol=2e-4, rtol=2e-4)
    compare("fg_history vs plain route", server.state.fg_history,
            plain.state.fg_history, atol=2e-4, rtol=2e-4)


def check_round(r, server, plain_engine, data, start, end) -> None:
    """Round ``r`` of the kernel route (``start`` -> ``end``) against one
    plain-route round from the same starting state: trust and the selected
    / on-time masks identical, params within the goldens' band, the
    defense history's rows within it up to kinked clients
    (``compare_rows``)."""
    got, out = plain_engine.step(start, data)
    for key, want in (("selected", out.selected), ("on_time", out.on_time)):
        if not np.array_equal(server.history[key][r], want.cpu().numpy()):
            raise AssertionError(f"round {r}: {key} differs from the plain route")
    if not torch.equal(end.trust.score, got.trust.score):
        raise AssertionError(f"round {r}: trust differs from the plain route")
    compare(f"round {r} params vs plain route", end.params, got.params,
            atol=2e-4, rtol=2e-4)
    # a row of the sketched history sums ~400 coordinates of one
    # client's delta, so a kinked client's row moves up to ~20x more
    if end.fg_history.numel():  # (N, 0) without a defense
        compare_rows(f"round {r} fg_history vs plain route", end.fg_history,
                     got.fg_history, atol=2e-4, rtol=2e-4, kink_atol=2e-2)


def check_each_round(server, plain_engine, data, starts) -> None:
    """Each round of the kernel route against one plain-route round from
    the same starting state (``check_round``).  Starting every round from
    the kernel route's state keeps fp32 rounding from compounding over
    rounds, so a kernel's error shows in the round that makes it."""
    ends = starts[1:] + [server.state]
    for r, (start, end) in enumerate(zip(starts, ends)):
        check_round(r, server, plain_engine, data, start, end)
    print(f"  rounds 0-{len(starts) - 1}: trust, selected and on-time masks "
          f"identical to the plain route from the same state")


def check_against_dense(server, dense_engine, dense_data, starts) -> None:
    """Each round of the gated packed run against the dense, ungated kernel
    route from the same state on the same fleet: the selected clients' SGD
    rows are bit-equal by construction, and only the compact cohort sums
    shift fp32 order, so trust and masks are identical and params within
    1e-5 (the reference's band for gated against full)."""
    ends = starts[1:] + [server.state]
    worst = 0.0
    for r, (start, end) in enumerate(zip(starts, ends)):
        got, out = dense_engine.step(start, dense_data)
        for key, want in (("selected", out.selected), ("on_time", out.on_time)):
            if not np.array_equal(server.history[key][r], want.cpu().numpy()):
                raise AssertionError(f"round {r}: {key} differs from the dense route")
        if not torch.equal(end.trust.score, got.trust.score):
            raise AssertionError(f"round {r}: trust differs from the dense route")
        compare(f"round {r} params vs dense ungated", end.params, got.params,
                atol=1e-5, rtol=1e-5)
        worst = max(worst, (end.fg_history - got.fg_history).abs().max().item())
    print(f"  rounds 0-{len(starts) - 1}: trust, selected and on-time masks identical "
          f"to the dense ungated route; fg_history max_abs_err={worst:.3e}")


def timed_rounds(server, data, eval_set, rounds: int, kernels, every,
                 force=None) -> tuple:
    """Sets every launch count (``every`` kernel of the port) to 0, runs
    ``rounds`` rounds, reads the counts; fails if a kernel of this path
    (``kernels``) never launched.  Returns the per-round wall seconds, the
    counts of this path's kernels and the state each round started from."""
    for k in every:
        k.launches = 0
    torch.cuda.synchronize()
    times, starts = [], []
    for _ in range(rounds):
        starts.append(server.state)
        t0 = time.perf_counter()
        server.run_round(data, eval_set=eval_set, force_straggler=force)
        times.append(time.perf_counter() - t0)
    launches = {k.__name__: k.launches for k in kernels}
    print(f"round seconds: {[round(t, 6) for t in times]}; rounds/s over all "
          f"{rounds}: {rounds / sum(times):.3f}; steady (rounds 2-{rounds}): "
          f"{(rounds - 1) / sum(times[1:]):.3f}")
    print(f"launches in this run: {launches}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} never launched on this path")
    return times, launches, starts


def check_codec_routes(kernel_engine, plain_engine, data, starts, force) -> None:
    """Each round run again from its starting state on the kernel route and
    with ``compress_impl="einsum"`` (the only difference): every carried
    tensor must be identical."""
    for r, start in enumerate(starts):
        got, out = kernel_engine.step(start, data, force_straggler=force)
        want, want_out = plain_engine.step(start, data, force_straggler=force)
        for name in ("params", "fg_history", "pending_delta", "pending_weight",
                     "pending_issued", "pending_arrival", "pending_valid",
                     "compress_residual"):
            if not torch.equal(getattr(got, name), getattr(want, name)):
                raise AssertionError(f"round {r}: {name} differs between the "
                                     "codec kernels and their plain versions")
        for a, b, name in ((got.trust.score, want.trust.score, "trust"),
                           (out.selected, want_out.selected, "selected"),
                           (out.on_time, want_out.on_time, "on_time")):
            if not torch.equal(a, b):
                raise AssertionError(f"round {r}: {name} differs between routes")
    print(f"  rounds 0-{len(starts) - 1}: params, residual, pending buffer, defense "
          f"history, trust and masks identical with compress_impl='einsum'")


def profile_round(server, data, eval_set, path: Path, label: str, force=None,
                  topk=False):
    """One round under ``torch.profiler``: writes the full table by device
    time and prints the device busy share of the round's wall time; with
    ``topk``, also a compressed round's device time by part."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run_round(data, eval_set=eval_set, force_straggler=force)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device-side rows only: a CPU op's row repeats its kernels' time
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    table = events.table(sort_by="self_device_time_total", row_limit=-1)
    path.mkdir(parents=True, exist_ok=True)
    (path / f"profile_{label}.txt").write_text(table)
    print(f"[profile] {label}: round wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}; table in "
          f"{path / f'profile_{label}.txt'}")
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:70]}")
    if topk:
        print(topk_split(events, on_device, busy_ms))


def topk_split(events, on_device, busy_ms) -> str:
    """A compressed round's device ms by part: ``torch.topk`` (the
    ``aten::topk`` op with the kernels it launches: its select and its
    sort), every ``aten::gather``, the two ``topk_decode`` launches,
    ``local_sgd``, and the rest."""
    def op_ms(name):
        return sum(e.device_time_total for e in events
                   if e.device_type == DeviceType.CPU and e.key == name) / 1e3

    def kernel_ms(part):
        return sum(e.self_device_time_total for e in on_device if part in e.key) / 1e3

    parts = {"torch.topk": op_ms("aten::topk"), "gather": op_ms("aten::gather"),
             "topk_decode": kernel_ms("topk_decode_kernel"),
             "local_sgd": kernel_ms("local_sgd_kernel")}
    parts["the rest"] = busy_ms - sum(parts.values())
    return "  device ms by part: " + ", ".join(
        f"{k} {v:.3f} ({v / busy_ms:.1%})" for k, v in parts.items())


# bf16 outputs: the kernel and the plain version each round an fp32 result
# to bf16 (8 bits of mantissa), so an element may differ by an ulp of
# itself; and the attention kernel rounds P to bf16 before P V, an error of
# a fraction of its row's values that shows on outputs near zero.  So each
# row (one head of one position) is held to its own largest value.
BF16_RTOL = 1.6e-2


def compare_by_row(name, got, want, *, rtol):
    """Row by row, for outputs whose last axis is a row (one head of one
    position): every element within ``rtol * max|want|`` over its own row,
    not over the whole output.  Prints the largest error and the largest
    ratio of an element's error to its tolerance.  Returns the largest
    error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = rtol * want.abs().amax(dim=-1, keepdim=True)
    worst = (err / limit.clamp_min(1e-30)).max().item()
    ok = bool((err <= limit).all())
    print(f"  {name}: max_abs_err={err.max().item():.3e}, largest error / tolerance "
          f"{worst:.3f} (tolerance rtol={rtol:g} * max|plain| of its row) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err.max().item()


# The fp32 scan, row by row against the float64 recurrence.  Its rounding
# is not the sequential fp32 recurrence's: the chunked form takes decays as
# exp(lc_i - lc_j), differences of cumsums that reach ~700 in a chunk at
# the model's decay range, so one row's error follows its chunk's decay
# history, not its own values, and the two fp32 versions' errors are not
# alike row by row.  Each row is held to FP32_SCAN_FACTOR x the largest
# error relative to its row that the fp32 plain version makes anywhere on
# the same inputs, times the row's own largest float64 value: the kernel
# may round as badly as fp32 does on these inputs, a few times over, and
# no worse.  A dropped term or a wrong mask is an error of the order of
# the row itself.
FP32_SCAN_FACTOR = 4


def compare_scan_fp32(name, got, plain, want64):
    """``got`` and ``plain`` (fp32) against ``want64`` (the float64
    recurrence) as FP32_SCAN_FACTOR says.  Prints the plain version's
    largest relative row error and the kernel's largest ratio of error to
    limit; returns the kernel's largest error against ``want64``."""
    row_max = want64.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
    rel_plain = ((plain.double() - want64).abs().amax(dim=-1, keepdim=True)
                 / row_max).max().item()
    err = (got.double() - want64).abs()
    limit = FP32_SCAN_FACTOR * rel_plain * row_max
    worst = (err / limit).max().item()
    ok = bool((err <= limit).all())
    print(f"  {name}: max_abs_err={err.max().item():.3e} against the float64 recurrence, "
          f"largest error / tolerance {worst:.3f} (tolerance {FP32_SCAN_FACTOR} x "
          f"{rel_plain:.3e}, the fp32 plain version's largest error relative to its "
          f"row, x max|float64| of the row) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the float64 recurrence")
    return err.max().item()


def attn_bound(B, S, H, K, hd, window, dtype):
    """Bytes: q and the output (H heads), k and v (K heads), once each.
    FLOPs: 2 products of 2 hd FLOPs per live (query, key) pair, the causal
    half (a band of ``window`` under a window).  Peak by input dtype."""
    w = window or S
    live = w * (w + 1) // 2 + (S - w) * w if S > w else S * (S + 1) // 2
    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * B * S * hd * (2 * H + 2 * K)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    return bound_ms(nbytes, 4 * B * H * hd * live, peak)


def ssd_bound(B, S, nh, hd, st, chunk, dtype):
    """Bytes: x in and y out (xd's dtype), the fp32 log-decays, B and C.
    FLOPs of the chunked SSD at the model's chunk L, counted from the
    reference's kernel: per (batch, chunk) one C B^T (2 L^2 st, shared by
    the heads), and per head the intra-chunk term over the causal half
    (L (L + 1) hd), the inter-chunk term and the state update (2 L st hd
    each).  Peak by input dtype."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * (2 * B * S * nh * hd + 2 * B * S * st) + 4 * B * S * nh
    L = min(chunk, S)
    nc = -(-S // L)
    flops = B * nc * (2 * L * L * st + nh * (L * (L + 1) * hd + 4 * L * st * hd))
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    return bound_ms(nbytes, flops, peak)


def lm_kernel_phase(ref, flash_attention, flash_attention_attrs, ssm, flash_cases,
                    ssm_cases, chunk):
    """Phase 2, the LM kernels at phase 9's shapes, each in the dtypes its
    case names, against their plain versions on the same inputs.  ``ssm``
    is the scan's (wrapper, ``kernel_attrs``, ``plan``).  Returns the JSON
    entries of each kernel's main-path case (its first, in bf16)."""
    entries = {}
    gen = torch.Generator(device=DEV).manual_seed(3)
    print("flash_attention, row by row (fp32: rtol = 1e-4, sums and exponentials "
          f"in another order; bf16: rtol = {BF16_RTOL}, an ulp of the output and P in "
          "bf16)")
    for hdp in (64, 128):
        print(f"  bf16 instance at head-dim padding {hdp}: "
              f"{flash_attention_attrs(hdp)} (a block: 384 threads; registers at "
              "launch, the consumers raise theirs to 240)")
    for n, (label, B, S, H, K, hd, window, dtypes) in enumerate(flash_cases):
        q32, k32, v32 = (torch.randn(B, S, h, hd, generator=gen, device=DEV)
                         for h in (H, K, K))
        for dtype in dtypes:
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            got = flash_attention(q, k, v, causal=True, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
            fp32 = dtype == torch.float32
            err = compare_by_row(f"{label}: (B, S, H, K, hd) = {(B, S, H, K, hd)}, "
                               f"window {window}, {str(dtype)[6:]}", got, want,
                               rtol=1e-4 if fp32 else BF16_RTOL)
            del got, want
            torch.cuda.empty_cache()
            # the library yardstick: one SDPA call in its own (B, H, S, hd)
            # layout, transposed outside the timed call
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            band = None
            if window:
                i = torch.arange(S, device=DEV)
                band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            k_ms = time_ms(lambda: flash_attention(q, k, v, causal=True, window=window),
                           reps=5)
            p_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                                           window=window), reps=3)
            lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, is_causal=band is None,
                enable_gqa=K != H), reps=5)
            b_ms, b_by = attn_bound(B, S, H, K, hd, window, dtype)
            print(f"    kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, library {lib_ms:.3f} ms "
                  f"(scaled_dot_product_attention), bound {b_ms:.4f} ms ({b_by})")
            if n == 0 and dtype == torch.bfloat16:
                entries["flash_attention"] = dict(
                    name="flash_attention", route="cuda",
                    source="src/repro_torch/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention.py:71", max_abs_err=err,
                    ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms)
            del q, k, v, qt, kt, vt

    ssm_scan, ssm_attrs, ssm_plan = ssm
    a = ssm_attrs()
    want_smem = ssm_plan(1, 1, 1, 64, 64)["smem_bytes"]
    print(f"ssm_scan bf16 instance: {a} (a block: 128 threads over 32 columns of a "
          f"head; the plan counts {want_smem} shared bytes)")
    if a["smem_bytes"] != want_smem or a["local_bytes"]:
        raise AssertionError("ssm_scan's plan and its build disagree on shared bytes, "
                             "or the kernel spills")
    print("ssm_scan against the sequential recurrence (bf16: row by row, rtol = "
          f"{BF16_RTOL}; fp32: row by row against the float64 recurrence, "
          f"{FP32_SCAN_FACTOR}x the fp32 plain version's own largest relative error)")
    for n, (label, B, S, nh, hd, st, dtypes) in enumerate(ssm_cases):
        # as the model makes them: dt = softplus(.), A = -linspace(1, 16, nh)
        dt = torch.nn.functional.softplus(torch.randn(B, S, nh, generator=gen, device=DEV))
        logdecay = dt * -torch.linspace(1.0, 16.0, nh, device=DEV)
        x32 = torch.randn(B, S, nh, hd, generator=gen, device=DEV) * dt[..., None]
        B32, C32 = (torch.randn(B, S, st, generator=gen, device=DEV) for _ in "BC")
        del dt
        print(f"  {label}: plan {ssm_plan(B, S, nh, hd, st)}")
        for dtype in dtypes:
            xd, Bc, Cc = (t.to(dtype) for t in (x32, B32, C32))
            got = ssm_scan(xd, logdecay, Bc, Cc)
            plain = ref.ssm_scan_ref(xd, logdecay, Bc, Cc)
            name = f"{label}: (B, S, nh, hd, st) = {(B, S, nh, hd, st)}, {str(dtype)[6:]}"
            if dtype == torch.float32:
                want64 = ref.ssm_scan_ref(xd, logdecay, Bc, Cc, dtype=torch.float64)
                err = compare_scan_fp32(name, got, plain, want64)
                del want64
            else:
                err = compare_by_row(name, got, plain.to(dtype), rtol=BF16_RTOL)
            del got, plain
            k_ms = time_ms(lambda: ssm_scan(xd, logdecay, Bc, Cc), reps=5)
            p_ms = time_ms(lambda: ref.ssm_scan_ref(xd, logdecay, Bc, Cc), reps=1)
            b_ms, b_by = ssd_bound(B, S, nh, hd, st, chunk, dtype)
            print(f"    kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, library none, bound "
                  f"{b_ms:.4f} ms ({b_by})")
            if n == 0 and dtype == torch.bfloat16:
                entries["ssm_scan"] = dict(
                    name="ssm_scan", route="cuda",
                    source="src/repro_torch/csrc/ssm_scan.cu",
                    replaces="src/repro/kernels/ssm_scan.py:65", max_abs_err=err,
                    ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=None)
            del xd, Bc, Cc
        del logdecay, x32, B32, C32
        torch.cuda.empty_cache()
    return entries


# each LM kernel's wrapper name -> the exact __global__ names it launches
LM_KERNEL_SYMBOLS = {
    "flash_attention": ("flash_attention_kernel", "flash_attention_fp32_fma_kernel"),
    "ssm_scan": ("ssm_scan_kernel", "ssm_scan_fp32_fma_kernel"),
}


def profile_device(run, names, path, label, units=1, unit="request"):
    """``run()`` (``units`` requests or decode steps, ending in a sync)
    under ``torch.profiler``: each kernel's device ms and launches per
    unit, and the device busy and idle share of the wall time.  A profiler
    row belongs to a kernel when its demangled name holds one of the
    kernel's ``LM_KERNEL_SYMBOLS`` as a whole word; the GEMM class is a
    guess from library kernel names, so the rows it does not take are
    printed.  Returns (wall ms, device busy ms, device launches) per unit."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    launches = sum(e.count for e in on_device)

    def owner(key):
        return next((n for n in names if any(re.search(rf"\b{sym}\b", key)
                                             for sym in LM_KERNEL_SYMBOLS[n])), None)

    per = {}
    for name in names:
        rows = [e for e in on_device if owner(e.key) == name]
        per[name] = (sum(e.self_device_time_total for e in rows) / 1e3 / units,
                     sum(e.count for e in rows) / units)
    print(f"[profile] {label}, {units} {unit}(s): wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, {launches} device "
          f"launches; per {unit}: " + ", ".join(
              f"{n} {ms:.3f} ms in {c:g} launches" for n, (ms, c) in per.items()))
    # device time by class: the port's kernels, cuBLAS GEMMs (by the names
    # cuBLAS gives them), and the rest (PyTorch's elementwise, reduction,
    # copy and memset kernels, and any library kernel named otherwise)
    split = {"kernels": [0.0, 0], "GEMMs": [0.0, 0], "the rest": [0.0, 0]}
    rest = []
    for e in on_device:
        key = e.key.lower()
        cls = ("kernels" if owner(e.key) else
               "GEMMs" if any(w in key for w in ("gemm", "nvjet", "xmma", "cutlass")) else
               "the rest")
        split[cls][0] += e.self_device_time_total / 1e3
        split[cls][1] += e.count
        if cls == "the rest":
            rest.append(e)
    print("  device time by class: " + ", ".join(
        f"{c} {ms:.3f} ms ({ms / busy_ms:.1%}, {n} launches)" for c, (ms, n) in split.items()))
    print("  the rest, largest first:")
    for e in sorted(rest, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    print("  all device time, largest first:")
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:70]}")
    if path is not None:
        path.mkdir(parents=True, exist_ok=True)
        (path / f"profile_{label}.txt").write_text(
            events.table(sort_by="self_device_time_total", row_limit=-1))
    return wall_ms / units, busy_ms / units, launches / units


def check_blocks(cfg, params, toks):
    """The route check, block by block: the request runs through the kernel
    route, and each of its block applications (every Mamba2 layer, and the
    shared attention block after every ``shared_attn_every``-th) also runs
    through the plain route from the same input.  Each block's increment to
    the residual must agree within atol = rtol = 1e-4 (fp32 sums in another
    order inside one block), and so must the logits from the last hidden
    state, with the same greedy token."""
    from repro_torch.models import blocks
    from repro_torch.models.layers import rms_norm

    worst = (-1.0, 0.0, 0.0)  # (err / limit, err, limit) of the closest block
    n = 0
    with torch.inference_mode():
        x = torch.nn.functional.embedding(toks.long(), params["embed"])
        pos = torch.arange(x.shape[1], device=x.device)
        shared = params["shared_attn"]

        def both(fn):
            nonlocal worst, n
            got, want = fn("kernel") - x, fn("einsum") - x
            err = (got - want).abs().max().item()
            limit = 1e-4 + 1e-4 * want.abs().max().item()
            if err > limit:
                raise AssertionError(f"block {n}: kernel route off by {err:.3e} "
                                     f"(tolerance {limit:.3e})")
            worst = max(worst, (err / limit, err, limit))
            n += 1
            return x + got, x + want

        for i, lp in enumerate(params["layers"]):
            x, last = both(lambda impl: blocks.mamba_block_forward(lp, x, cfg, impl))
            if (i + 1) % cfg.shared_attn_every == 0:
                x, last = both(lambda impl: blocks.attn_block_forward(
                    shared, x, pos, cfg, cfg.sliding_window, impl))

        w_head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]

        def head(h):
            return rms_norm(h[:, -1], params["final_norm"], cfg.norm_eps) @ w_head

        lk, lpl = head(x), head(last)
    print(f"  {n} blocks, each from the same input on both routes: closest to its "
          f"tolerance max_abs_err={worst[1]:.3e} (tolerance {worst[2]:.3e}: atol=1e-4 + "
          f"rtol=1e-4 * max|plain increment|) ok")
    compare("logits from the last block's two outputs", lk, lpl, atol=1e-4, rtol=1e-4)
    if not torch.equal(lk.argmax(-1), lpl.argmax(-1)):
        raise AssertionError("the greedy token differs between the kernel and plain routes")
    top2 = torch.topk(lpl, 2, dim=-1).values
    print(f"  greedy token {lk.argmax(-1).tolist()} identical on both routes ok "
          f"(top-2 gap {(top2[:, 0] - top2[:, 1]).tolist()})")


def serve_phase(cfg, lm_kernels, every, requests, expect_params, profile_dir):
    """Phase 9: serving prefill.  ``requests`` is a list of (batch, seq)
    shapes, the first a warm-up; each request's launches must be one
    ``flash_attention`` per shared-block application and one ``ssm_scan``
    per layer.  Returns the launch counts of the timed run, and the model
    and its params for phase 9b."""
    from repro_torch.models.model import Model, param_count
    from repro_torch.models.ssm import ssm_dims

    flash, ssm = lm_kernels
    t0 = time.perf_counter()
    model = Model(cfg)
    params = model.init_params(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    n_params = param_count(params)
    print(f"[set-up] {cfg.name}: {n_params:,} params in {cfg.dtype} "
          f"({torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card) in "
          f"{time.perf_counter() - t0:.2f} s")
    if expect_params is not None and n_params != expect_params:
        raise AssertionError(f"{n_params} params, the reference has {expect_params}")
    per_req = (cfg.num_layers // cfg.shared_attn_every, cfg.num_layers)
    gen = torch.Generator(device=DEV).manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, shape, generator=gen, device=DEV)
               for shape in requests]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in every:
        k.launches = 0
    times = []
    for toks in prompts:
        before = (flash.launches, ssm.launches)
        t0 = time.perf_counter()
        logits = model.prefill(params, {"tokens": toks})
        greedy = logits.argmax(-1).cpu()  # the request's answer; a sync
        times.append(time.perf_counter() - t0)
        got = (flash.launches - before[0], ssm.launches - before[1])
        if got != per_req:
            raise AssertionError(f"request {tuple(toks.shape)} launched (flash_attention, "
                                 f"ssm_scan) = {got}, expected {per_req}")
        if (logits.shape != (toks.shape[0], cfg.vocab_size)
                or not torch.isfinite(logits).all()
                or not ((greedy >= 0) & (greedy < cfg.vocab_size)).all()):
            raise AssertionError("prefill gave misshapen or non-finite logits")
        print(f"  request {tuple(toks.shape)}: {times[-1] * 1e3:.3f} ms, greedy "
              f"{greedy.tolist()}, launches flash_attention {got[0]}, ssm_scan {got[1]}")
    launches = {k.__name__: k.launches for k in lm_kernels}
    print(f"launches in this run: {launches}")
    timed = times[1:]
    ntok = sum(int(t.numel()) for t in prompts[1:])
    print(f"requests/s over requests 2-{len(times)}: {len(timed) / sum(timed):.4f}; "
          f"prompt tokens/s: {ntok / sum(timed):.1f}")
    print(f"max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    _, nh = ssm_dims(cfg)
    dtype = getattr(torch, cfg.dtype)
    for toks in {tuple(t.shape): t for t in prompts}.values():
        profile_device(lambda: model.prefill(params, {"tokens": toks}).argmax(-1).cpu(),
                       ("flash_attention", "ssm_scan"), profile_dir,
                       f"prefill_{toks.shape[0]}x{toks.shape[1]}")
        fb = attn_bound(*toks.shape, cfg.num_heads, cfg.num_kv_heads,
                        cfg.resolved_head_dim, cfg.sliding_window, dtype)
        sb = ssd_bound(*toks.shape, nh, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk,
                       dtype)
        print(f"  bound a launch: flash_attention {fb[0]:.4f} ms ({fb[1]}), ssm_scan "
              f"{sb[0]:.4f} ms ({sb[1]})")
    del logits, prompts
    return launches, model, params


def route_phase(cfg, lm_kernels, check_shape):
    """Phase 9's route check in fp32 at ``check_shape``: the kernel route
    against the plain route, block by block and free-running.  Returns the
    fp32 model and its params (seed 2) for phase 9b."""
    from repro_torch.models.model import Model

    flash, ssm = lm_kernels
    per_req = (cfg.num_layers // cfg.shared_attn_every, cfg.num_layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = Model(cfg32)
    params = model.init_params(torch.Generator(device=DEV).manual_seed(2))
    gen = torch.Generator(device=DEV).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, check_shape, generator=gen, device=DEV)
    before = (flash.launches, ssm.launches)
    got = model.prefill(params, {"tokens": toks})
    if (flash.launches - before[0], ssm.launches - before[1]) != per_req:
        raise AssertionError("the fp32 kernel route did not run each kernel per layer")
    plain = Model(cfg32, attn_impl="einsum", ssm_impl="einsum")
    t0 = time.perf_counter()
    want = plain.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    print(f"[route check] {cfg.name} fp32, {check_shape}: plain route in "
          f"{time.perf_counter() - t0:.3f} s")
    check_blocks(cfg32, params, toks)
    # the whole request, each route on its own trajectory: the random-init
    # trunk amplifies any rounding difference layer after layer, so the two
    # are set beside two plain routes that differ only in the SSD's chunk
    # (128 and 64: the same function summed in another order)
    other = Model(dataclasses.replace(cfg32, ssm_chunk=cfg.ssm_chunk // 2),
                  attn_impl="einsum", ssm_impl="einsum").prefill(params, {"tokens": toks})
    for t in (got, want, other):
        if t.shape != (check_shape[0], cfg.vocab_size) or not torch.isfinite(t).all():
            raise AssertionError("the route check's logits are misshapen or non-finite")
    print(f"  free-running request (no tolerance: the trunk is chaotic): kernel vs "
          f"plain route max_abs_err={(got - want).abs().max().item():.3e}; plain vs "
          f"plain with chunk {cfg.ssm_chunk // 2}: {(want - other).abs().max().item():.3e}; "
          f"max|plain| {want.abs().max().item():.3f}; greedy tokens kernel "
          f"{got.argmax(-1).tolist()}, plain {want.argmax(-1).tolist()}, plain with chunk "
          f"{cfg.ssm_chunk // 2} {other.argmax(-1).tolist()}")
    del got, want, other
    return model, params


# ---------------------------------------------------------------- phase 9b
def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nest of dicts and lists."""
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def block_applications(cfg, params, cache):
    """(kind, block params, window, cache slot) of each block application
    of one decode step, in trunk order, as ``Model.decode_step`` walks
    them."""
    from repro_torch.models.model import layer_windows

    if "shared_attn" not in params:
        return [("attn", lp, w, c) for lp, w, c in
                zip(params["layers"], layer_windows(cfg).tolist(), cache)]
    apps, slots = [], iter(cache["attn"])
    for i, (lp, c) in enumerate(zip(params["layers"], cache["mamba"])):
        apps.append(("mamba", lp, None, c))
        if (i + 1) % cfg.shared_attn_every == 0:
            apps.append(("attn", params["shared_attn"], cfg.sliding_window, next(slots)))
    return apps


def decode_step_bytes(cfg, params, cache, batch: int, positions) -> list:
    """The bytes a decode step must move, at each of ``positions``: every
    weight it uses read once per use (zamba's shared block once per
    application), the Mamba2 conv history and fp32 state read and written,
    the KV slots that hold a position in the window read and the new slot
    written, the embedding rows read and the logits written."""
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    fixed = (tensor_bytes(head) + tensor_bytes(params["final_norm"])
             + batch * (cfg.d_model + cfg.vocab_size) * params["embed"].element_size())
    kv = []  # (slots, window, bytes a slot) of each attention application
    for kind, lp, window, c in block_applications(cfg, params, cache):
        fixed += tensor_bytes(lp)
        if kind == "mamba":
            fixed += 2 * tensor_bytes(c)
        else:
            clen = c["k"].shape[1]
            kv.append((clen, window or clen, tensor_bytes(c) // clen))
    return [fixed + sum(slot * (min(p + 1, w, clen) + 1) for clen, w, slot in kv)
            for p in positions]


def decode_run(model, params, batch, every, gen, profile_dir, prompt_len=512, gen_len=128,
               warmup=8, profile_steps=4):
    """Phase 9b: one serving run as ``examples/serve_decode.py`` does it:
    ``batch`` random prompts of ``prompt_len`` tokens stepped through a
    fresh cache, then ``gen_len`` greedy tokens, the next token kept on the
    card (no host sync until the end).  ``warmup`` steps on another cache
    come first.  No kernel of ``every`` may launch.  Prints ms a step
    (host clock over all steps), the prompt / generation split (CUDA
    events), generated tokens/s, launches a step and the device idle share
    (``torch.profiler`` over ``profile_steps`` more steps), peak memory,
    cache bytes and the step's bytes bound."""
    cfg = model.cfg
    total = prompt_len + gen_len
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=DEV)
    cache = model.init_cache(batch, total)
    for t in range(warmup):
        model.decode_step(params, cache, prompt[:, t:t + 1], t)
    torch.cuda.synchronize()
    cache = model.init_cache(batch, total)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in every:
        k.launches = 0
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    out = []
    t0 = time.perf_counter()
    marks[0].record()
    for t in range(prompt_len):
        logits, cache = model.decode_step(params, cache, prompt[:, t:t + 1], t)
    last_prompt = logits
    marks[1].record()
    tok = logits.argmax(-1, keepdim=True)
    for t in range(prompt_len, total):
        out.append(tok)
        finite &= torch.isfinite(logits).all()
        logits, cache = model.decode_step(params, cache, tok, t)
        tok = logits.argmax(-1, keepdim=True)
    marks[2].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k.__name__: k.launches for k in every if k.launches}
    if launched:
        raise AssertionError(f"decode launched kernels {launched}; it must reach none")
    gen_toks = torch.cat(out, dim=1)
    if not (bool(finite) and bool(torch.isfinite(logits).all())):
        raise AssertionError("decode gave non-finite logits")
    if gen_toks.shape != (batch, gen_len) or not (
            (gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all():
        raise AssertionError("decode gave tokens outside the vocabulary")
    peak = torch.cuda.max_memory_allocated()
    ms_step = wall * 1e3 / total
    gen_ms = marks[1].elapsed_time(marks[2])
    bound = [n / PEAK_BYTES_PER_S * 1e3
             for n in decode_step_bytes(cfg, params, cache, batch, range(total))]
    print(f"  B = {batch}: {total} steps ({prompt_len} prompt + {gen_len} generated) in "
          f"{wall:.3f} s: {ms_step:.3f} ms a step (host clock), prompt "
          f"{marks[0].elapsed_time(marks[1]) / prompt_len:.3f} / generation "
          f"{gen_ms / gen_len:.3f} ms a step (events); generated tokens/s "
          f"{batch * gen_len / gen_ms * 1e3:.1f}; bound {statistics.mean(bound):.4f} ms a "
          f"step (bytes at 3.35 TB/s, mean over the run; {bound[-1]:.4f} at the last step)")
    print(f"  launches of the nine kernels during decode: none ok; cache "
          f"{tensor_bytes(cache) / 2**30:.4f} GiB; max_memory_allocated "
          f"{peak / 2**30:.3f} GiB; greedy tokens of sequence 0: "
          f"{gen_toks[0, :12].tolist()}")

    def more_steps():
        step_logits = logits
        for t in range(total - profile_steps, total):
            step_logits, _ = model.decode_step(params, cache, step_logits.argmax(-1, keepdim=True),
                                               t)
        torch.cuda.synchronize()

    _, busy, launches = profile_device(more_steps, ("flash_attention", "ssm_scan"), profile_dir,
                                       f"decode_{cfg.name}_B{batch}", profile_steps, "step")
    print(f"  {launches:g} device launches a step; device busy {busy:.3f} ms a step, idle "
          f"share against the unprofiled step {1 - busy / ms_step:.3f}")
    # stepped decode against the kernel-route prefill of the same prompt, in
    # bf16: no tolerance (Trap 3: the random-init trunk amplifies rounding)
    pre = model.prefill(params, {"tokens": prompt})
    print(f"  decode at the prompt's last position vs prefill (kernel route, bf16, no "
          f"tolerance): max_abs_err {(last_prompt - pre).abs().max().item():.3e}, max|prefill| "
          f"{pre.abs().max().item():.3f}, greedy tokens equal in "
          f"{int((last_prompt.argmax(-1) == pre.argmax(-1)).sum())} of {batch}")
    del cache, pre, last_prompt


def serve_decode(model, params, batches, every, gen, profile_dir):
    """Phase 9b's bf16 runs of one model: ``decode_run`` at each batch."""
    from repro_torch.models.model import param_count

    cfg = model.cfg
    print(f"\n[serve decode] {cfg.name}, {cfg.dtype}, {param_count(params):,} params "
          f"({cfg.num_heads} heads over {cfg.num_kv_heads} kv heads): a 512-token prompt "
          f"stepped through the cache, then 128 greedy tokens")
    for batch in batches:
        decode_run(model, params, batch, every, gen, profile_dir)


def decode_checks(model, params, every, gen):
    """Phase 9b's fp32 decode-vs-prefill checks: ``model`` (zamba2-7b, phase
    9's route-check params), then tinyllama-1.1b at full width, and the same
    with a 128-slot ring that wraps once over the 256 positions.  No kernel
    of ``every`` may launch."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    print("\n[decode vs prefill] fp32, block by block, from the plain prefill's input to "
          "each block")
    for k in every:
        k.launches = 0
    shape = (2, 256)
    check_decode_blocks(model, params, torch.randint(0, model.cfg.vocab_size, shape,
                                                     generator=gen, device=DEV))
    tiny = dataclasses.replace(get_config("tinyllama-1.1b"), dtype="float32")
    tiny_model = Model(tiny)
    tiny_params = tiny_model.init_params(torch.Generator(device=DEV).manual_seed(6))
    toks = torch.randint(0, tiny.vocab_size, shape, generator=gen, device=DEV)
    check_decode_blocks(tiny_model, tiny_params, toks)
    check_decode_blocks(Model(dataclasses.replace(tiny, sliding_window=128)), tiny_params, toks)
    launched = {k.__name__: k.launches for k in every if k.launches}
    if launched:
        raise AssertionError(f"the decode check launched kernels {launched}")


def check_decode_blocks(model, params, toks):
    """Phase 9b's decode-vs-prefill check in fp32, block by block: for each
    block application, from the plain prefill's input to that block, the
    block's plain forward over T positions against its decode stepped
    t = 0..T-1 from an empty cache.  Each position's increment to the
    residual must agree within atol = rtol = 1e-4 of that row's largest
    plain increment (``check_blocks``' rule, row by row); each Mamba2
    layer's final fp32 state must agree with ``ssd_chunked``'s in the same
    way, a row being one head of one sequence."""
    from repro_torch.models import blocks
    from repro_torch.models import ssm
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import decode_cache_len

    cfg = model.cfg
    B, T = toks.shape
    worst = {"mamba": 0.0, "attn": 0.0, "state": 0.0}

    def check(what, got, want, dims):
        limit = 1e-4 + 1e-4 * want.abs().amax(dim=dims, keepdim=True)
        ratio = ((got - want).abs() / limit).max().item()
        if not ratio <= 1.0:
            raise AssertionError(f"{cfg.name}: a {what} is off by {ratio:.3f} of its "
                                 f"tolerance")
        worst[what] = max(worst[what], ratio)

    t0 = time.perf_counter()
    with torch.inference_mode():
        x = torch.nn.functional.embedding(toks.long(), params["embed"])
        positions = torch.arange(T, device=DEV)
        cache = model.init_cache(B, T)
        apps = block_applications(cfg, params, cache)
        for kind, lp, window, c in apps:
            if kind == "mamba":
                want = blocks.mamba_block_forward(lp, x, cfg, "einsum")
                got = [blocks.mamba_block_decode(lp, c, x[:, t:t + 1], cfg)[0]
                       for t in range(T)]
                *_, xd, logdecay, Bc, Cc = ssm.scan_inputs(
                    lp["mamba"], rms_norm(x, lp["ln"], cfg.norm_eps), cfg)
                _, state = ssm.ssd_chunked(xd, logdecay, Bc, Cc, cfg.ssm_chunk)
                check("state", c["ssm"], state, (2, 3))
            else:
                want = blocks.attn_block_forward(lp, x, positions, cfg, window, "einsum")
                got = [blocks.attn_block_decode(lp, c, x[:, t:t + 1], t, cfg, window)[0]
                       for t in range(T)]
            check(kind, torch.cat(got, dim=1) - x, want - x, -1)
            x = want
    print(f"  {cfg.name}, window {cfg.sliding_window} ({decode_cache_len(cfg, T)} KV "
          f"slots): {len(apps)} blocks, {B} x {T} positions each, in "
          f"{time.perf_counter() - t0:.2f} s; closest to tolerance (row by row): "
          + ", ".join(f"{k} {v:.3f}" for k, v in worst.items() if v) + " ok")


# ---------------------------------------------------------------- phase 10
# the store columns a cohort round must leave identical on both routes
STORE_EXACT = ("score", "participations", "failures", "battery", "last_selected",
               "pending_weight", "pending_issued", "pending_arrival", "pending_valid")


def store_copy(store) -> dict:
    """A deep copy of a ``ClientStore``'s columns and round counter."""
    return {k: np.array(v, copy=True) for k, v in store.state_dict().items()}


def record_levels(engine) -> list:
    """Wraps the engine's QSGD decode so that every round's largest level
    (scale / L) is appended to the returned list, as a device scalar."""
    comp = engine.compression
    levels, decode = [], comp.decode

    def recording(payload, dim):
        levels.append(payload["scale"].max() / comp.levels)
        return decode(payload, dim)

    comp.decode = recording
    return levels


def compare_flips(name, got, want, level, flips_row=None):
    """Rows of a QSGD run on two routes.  A code whose uniform lies within
    the routes' ~1e-7 SGD difference of its rounding boundary rounds the
    other way on one of them and moves its element by one level, so: every
    element within ``level`` + 2e-4 and at most 1e-3 of them over 2e-4
    (residual, pending buffer).  With ``flips_row`` (the residual's flipped
    elements per row) each sketch row is held within that many levels +
    2e-4 instead.  Returns the residual's flips per row."""
    err = (got - want).abs()
    over = err > 2e-4 + 2e-4 * want.abs()
    if flips_row is None:
        share = over.float().mean().item()
        ok = err.max().item() <= level + 2e-4 and share <= 1e-3
        print(f"  {name}: max_abs_err={err.max().item():.3e}, {share:.2e} of elements "
              f"over 2e-4 (at most 1e-3, each within one level {level:.3e} + 2e-4) "
              f"{'ok' if ok else 'FAIL'}")
    else:
        row_err = err.amax(dim=1)
        bound = flips_row * level + 2e-4
        ok = bool((row_err <= bound).all())
        print(f"  {name}: max_abs_err={row_err.max().item():.3e}, every row within its "
              f"flipped codes x {level:.3e} + 2e-4 {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} differs between the kernel and plain routes "
                             "beyond QSGD code flips")
    return over.sum(dim=1)


def check_cohort_round(r, kernel, plain, levels):
    """The last cohort round of the kernel-route server against the plain
    route's from the same store and params: the cohort, trust, the masks
    and every bookkeeping column identical; params within the goldens'
    band; the cohort's history rows within phase 4's kink bound, or, under
    QSGD, the residual, pending buffer and history up to code flips
    (``compare_flips``)."""
    idx, valid = kernel.history["cohort"][-1]
    pidx, pvalid = plain.history["cohort"][-1]
    if not (np.array_equal(idx, pidx) and np.array_equal(valid, pvalid)):
        raise AssertionError(f"round {r}: the cohort differs from the plain route")
    for key in ("trust", "selected", "on_time"):
        if not np.array_equal(kernel.history[key][-1], plain.history[key][-1]):
            raise AssertionError(f"round {r}: {key} differs from the plain route")
    ks, ps = kernel.engine.store, plain.engine.store
    for name in STORE_EXACT:
        if not np.array_equal(getattr(ks, name), getattr(ps, name)):
            raise AssertionError(f"round {r}: store column {name} differs from the "
                                 "plain route")
    compare(f"round {r} params vs plain route", kernel.engine.params,
            plain.engine.params, atol=2e-4, rtol=2e-4)
    rows = idx[valid]

    def dev(store, name):
        return torch.as_tensor(getattr(store, name)[rows], device=DEV)

    if levels is None:
        compare_rows(f"round {r} cohort history rows vs plain route",
                     dev(ks, "history"), dev(ps, "history"), atol=2e-4, rtol=2e-4,
                     kink_atol=2e-2)
        return
    level = max(float(v) for v in levels)
    flips = compare_flips(f"round {r} cohort residual rows", dev(ks, "residual"),
                          dev(ps, "residual"), level)
    compare_flips(f"round {r} cohort pending rows", dev(ks, "pending_delta"),
                  dev(ps, "pending_delta"), level)
    compare_flips(f"round {r} cohort history rows", dev(ks, "history"),
                  dev(ps, "history"), level, flips_row=flips)


def cohort_rounds(server, fleet, eval_set, rounds, kernels, every, plain=None,
                  check=(), save_after=None):
    """Phase 10's run: sets every launch count to 0, runs ``rounds`` cohort
    rounds through ``FedARServer.run_round`` (host clock around each, the
    engine's per-part split on), and reads the counts; fails if a kernel of
    this path (``kernels``) never launched.  Before each round in ``check``
    the plain-route server ``plain`` is set to the kernel route's store and
    params, runs the same round, and ``check_cohort_round`` holds the two.
    After round ``save_after`` the store is saved (``save_store``, outside
    the round's clock) to a temporary file, whose path is returned.
    Returns (per-round seconds, per-round launches, checkpoint path)."""
    from repro_torch.checkpoint.ckpt import save_store

    eng = server.engine
    eng.timings = {}
    levels = (record_levels(eng.engine) if plain is not None
              and eng.compression.active else None)
    ckpt = None
    for k in every:
        k.launches = 0
    torch.cuda.synchronize()
    times, per_round = [], []
    for r in range(rounds):
        if r in check:
            plain.engine.store.load_state_dict(eng.store.state_dict())
            plain.engine.params = eng.params.clone()
        if levels is not None:
            levels.clear()
        before = {k.__name__: k.launches for k in kernels}
        t0 = time.perf_counter()
        server.run_round(fleet, eval_set=eval_set)
        times.append(time.perf_counter() - t0)
        per_round.append({k.__name__: k.launches - before[k.__name__] for k in kernels})
        valid = server.history["cohort"][-1][1]
        counts = {k: int(v.sum().item()) for k, v in eng.engine.fault_masks.items()}
        print(f"round {r}: {times[-1]:.6f} s, acc {server.history['acc'][-1]:.4f}, "
              f"{int(valid.sum())} valid slots, {int(server.history['selected'][-1].sum())} "
              f"selected; fault slots {counts}; launches {per_round[-1]}")
        if not torch.isfinite(eng.params).all():
            raise AssertionError(f"round {r}: non-finite params")
        if r in check:
            plain.run_round(fleet, eval_set=eval_set)
            check_cohort_round(r, server, plain, levels)
        if r == save_after:
            ckpt = Path(tempfile.mkdtemp(prefix="cohort_ckpt_")) / "store.pt"
            t0 = time.perf_counter()
            save_store(str(ckpt), eng.store, params=eng.params, step=r + 1)
            print(f"  save_store after round {r}: {ckpt.stat().st_size / 1e9:.3f} GB "
                  f"in {time.perf_counter() - t0:.2f} s")
    launches = {k.__name__: k.launches for k in kernels}
    print(f"rounds/s over all {rounds}: {rounds / sum(times):.3f}; steady (rounds "
          f"2-{rounds}): {(rounds - 1) / sum(times[1:]):.3f}; launches in this run: "
          f"{launches}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} never launched on this path")
    split = {part: statistics.mean(eng.timings[part][1:]) * 1e3 for part in eng.PARTS}
    print("steady round by part (ms, mean of rounds 2 on, the card synchronized at each "
          "boundary): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; sum {sum(split.values()):.3f}")
    eng.timings = None
    return times, per_round, ckpt


def check_resume(fed, fleet, eval_set, req, ckpt, whole, rounds_after) -> None:
    """A fresh cohort server restored from ``ckpt`` runs ``rounds_after``
    rounds; every store column, params and trust must equal the
    uninterrupted run's (``whole``) bit for bit."""
    from repro_torch.checkpoint.ckpt import restore_store
    from repro_torch.configs.fedar_mnist import MnistConfig
    from repro_torch.core.fedar import FedARServer

    server = FedARServer(MnistConfig(), fed, req, device=DEV)
    t0 = time.perf_counter()
    params, step = restore_store(str(ckpt), server.engine.store, with_params=True)
    server.engine.params = params.to(DEV)
    print(f"  restore_store: round {step} in {time.perf_counter() - t0:.2f} s")
    server.run(fleet, rounds=rounds_after, eval_set=eval_set)
    want, got = whole.engine.store, server.engine.store
    for name, col in want.state_dict().items():
        if not np.array_equal(got.state_dict()[name], col):
            raise AssertionError(f"resumed run: store column {name} differs from the "
                                 "uninterrupted run")
    if not torch.equal(server.engine.params, whole.engine.params):
        raise AssertionError("resumed run: params differ from the uninterrupted run")
    print(f"  resumed after round {step}, {rounds_after} rounds: every store column, "
          f"params and trust bit-equal to the uninterrupted run")


def cohort_sgd_check(server, fleet, ref, local_sgd) -> dict:
    """``local_sgd`` at the cohort's shape (R = K, n = 200, the last round's
    cohort with its sample mask) against its plain version, timed."""
    eng = server.engine
    idx, valid = server.history["cohort"][-1]
    data = eng.engine.device_data(fleet.cohort_arrays(idx, valid))
    g = eng.params
    args = (data["x"], data["y"], data["activations"], data["mask"])
    kw = dict(hidden=128, classes=10, lr=0.1, batch_size=20, epochs=5)
    want = ref.local_sgd_ref(g, *args, **kw)
    err = compare_rows(f"local_sgd at R={len(idx)}, n={data['x'].shape[1]} vs plain",
                       local_sgd(g, *args, **kw), want, atol=1e-4, rtol=1e-4,
                       kink_atol=2e-3)
    k_ms = time_ms(lambda: local_sgd(g, *args, **kw), reps=5)
    p_ms = time_ms(lambda: ref.local_sgd_ref(g, *args, **kw), reps=3)
    xb, yb, ab, mb = args
    b_ms, b_by = bound_ms(4 * (xb.numel() + yb.numel() + mb.numel() + ab.numel()
                               + eng.dim * (1 + xb.shape[0])),
                          sgd_flops(mb, 20, 784, 128, 10, 5))
    print(f"  kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.3g} ms ({b_by})")
    return dict(shape=f"R={len(idx)}, n={xb.shape[1]}", max_abs_err=err, ms=k_ms,
                plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)


def cohort_phase(req, eval_set, kernels, codecs, every, ref, local_sgd, entries):
    """Phase 10: the host-store cohort engine with chaos faults."""
    import dataclasses as dc

    from repro_torch.configs.fedar_mnist import MnistConfig, fleet_fed
    from repro_torch.core.fedar import FedARServer
    from repro_torch.data.datasets import VirtualFleet

    def plain_of(fed):
        return dc.replace(fed, sgd_impl="einsum", agg_impl="einsum",
                          defense_impl="einsum", compress_impl="einsum")

    # --- 10a: chaos at a million clients, K = 256
    t0 = time.perf_counter()
    fleet = VirtualFleet(1_000_000, samples_per_client=200)
    fed = fleet_fed(1_000_000, cohort_size=256, aggregation="fedar",
                    defense="foolsgold_sketch", faults="chaos")
    server = FedARServer(MnistConfig(), fed, req, device=DEV)
    plain = FedARServer(MnistConfig(), plain_of(fed), req, device=DEV)
    store = server.engine.store
    print(f"\n[cohort, chaos] 1,000,000 clients, K = 256, fedar + foolsgold_sketch; "
          f"host store {store.nbytes / 1e9:.3f} GB (history {store.history.nbytes / 1e9:.3f}); "
          f"fleet, store and engines built in {time.perf_counter() - t0:.2f} s (set-up)")
    rounds = 6
    _, per_round, _ = cohort_rounds(server, fleet, eval_set, rounds, kernels, every,
                                    plain=plain, check=range(rounds))
    print(f"  rounds 0-{rounds - 1}: cohort, trust, masks and store bookkeeping identical "
          f"to the plain route from the same store")
    sgd = cohort_sgd_check(server, fleet, ref, local_sgd)
    del server, plain, fleet, store

    # --- 10b: the quickstart's compressed async line at a fleet the host holds
    fed_b = fleet_fed(10_000, cohort_size=256, aggregation="async", compress="qsgd",
                      compress_bits=4, defense="foolsgold_sketch", faults="chaos")
    fleet = VirtualFleet(10_000, samples_per_client=200)
    server = FedARServer(MnistConfig(), fed_b, req, device=DEV)
    plain = FedARServer(MnistConfig(), plain_of(fed_b), req, device=DEV)
    store = server.engine.store
    print(f"\n[cohort, async + qsgd-4 + chaos] 10,000 clients, K = 256; host store "
          f"{store.nbytes / 1e9:.3f} GB (residual and pending columns "
          f"{(store.residual.nbytes + store.pending_delta.nbytes) / 1e9:.3f} GB; the "
          f"quickstart's 100,000 clients would need "
          f"{(store.residual.nbytes + store.pending_delta.nbytes) * 10 / 1e9:.1f} GB for "
          f"those two)")
    _, per_round_b, ckpt = cohort_rounds(server, fleet, eval_set, rounds,
                                         kernels + codecs[:2], every, plain=plain,
                                         check=(0, 1), save_after=2)
    print(f"  rounds 0-1: cohort, trust, masks and store bookkeeping identical to the "
          f"plain route from the same store")
    del plain
    check_resume(fed_b, fleet, eval_set, req, ckpt, server, rounds - 3)
    shutil.rmtree(ckpt.parent)
    launches10 = {}
    for p in per_round + per_round_b:
        for name, count in p.items():
            launches10[name] = launches10.get(name, 0) + count
    print(f"launches in phase 10 (10a and 10b, 12 rounds): {launches10}")
    for name, count in launches10.items():
        entries[name]["phase10"] = {"launches": count}
    entries["local_sgd"].setdefault("phase10", {}).update(sgd)


# ---------------------------------------------------------------- phase 11
class PartTimer:
    """Wall seconds of named parts of a round: ``wrap`` brackets each call
    of a callable with device syncs and adds its time to its part."""

    def __init__(self):
        self.parts = {}

    def wrap(self, name, fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t0
            return out
        return timed


def lm_timeout(fed, model, data, dim: int, rounds: int) -> float:
    """A timeout from the fleet's own latencies (the engine's latency model
    and draws, before round 1): the largest, over the run's rounds, of the
    honest clients' median latency, plus 1%, so that at least two of the
    three honest robots arrive in time every round.  The example's 10
    virtual seconds would make every robot late at this width."""
    from repro_torch.convert import GeneratorDraws
    from repro_torch.core.resources import make_fleet, round_latency

    N = fed.num_clients
    res, poison = make_fleet(N, num_starved=fed.num_starved,
                             num_poisoners=fed.num_poisoners, seed=fed.seed, device=DEV)
    flops = model.train_flops(tuple(data["tokens"].shape[1:]), epochs=fed.local_epochs)
    draws = GeneratorDraws(fed.seed, DEV)
    lat = torch.stack([round_latency(res, train_flops=flops, model_bytes=dim * 4.0,
                                     factor=draws.latency_factor(r, N))
                       for r in range(rounds)]).cpu()
    honest = torch.as_tensor(~poison)
    timeout = 1.01 * float(lat[:, honest].median(dim=1).values.max())
    print(f"  virtual latencies (s), rounds x clients: {lat.numpy().round(1).tolist()}; "
          f"poisoners {np.where(poison)[0].tolist()}; timeout {timeout:.1f} s")
    return timeout


def lm_fleet(cfg, N: int, samples: int, *, attn_impl="auto", **fed_kw):
    """The LM fleet of ``examples/federated_lm.py``: an ``LMClientModel``, a
    ``fleet_fed(N)`` and the corpus_skew corpus (24 sequences of 64 a
    client, 4 topics, the fleet's poisoners' labels scrambled).  Returns
    (model, fed, data, eval set)."""
    from repro_torch.configs.fedar_mnist import fleet_fed
    from repro_torch.core.resources import make_fleet
    from repro_torch.data.pipeline import federated_lm_corpus
    from repro_torch.models.model import LMClientModel

    model = LMClientModel(cfg, device=DEV, attn_impl=attn_impl)
    fed = fleet_fed(N, local_epochs=2, local_batch_size=8, **fed_kw)
    _, poison = make_fleet(N, num_starved=fed.num_starved,
                           num_poisoners=fed.num_poisoners, seed=fed.seed)
    data, meta = federated_lm_corpus(N, vocab=cfg.vocab_size, seq=64,
                                     samples_per_client=samples, topics=4,
                                     poisoners=tuple(np.where(poison)[0].tolist()))
    return model, fed, data, meta["eval"]


def lm_train_phase(req, every, entries, smi: str, profile_dir=None) -> None:
    """Phase 11: federated LM training at full width: tinyllama-1.1b
    clients through ``FedARServer`` (fedar + foolsgold_sketch, 4 clients,
    4 rounds), each round held against a plain-route round from the same
    state; the count sketch and ``fedavg_agg`` at its (4, D); then the
    example's reduced fleet (async + foolsgold_sketch and fedavg + none, 8
    clients, 8 rounds) with the same route check."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.core import aggregation as agg
    from repro_torch.core.engine import ordered_leaves
    from repro_torch.core.fedar import FedARServer
    from repro_torch.kernels import ref
    from repro_torch.kernels.count_sketch import count_sketch
    from repro_torch.kernels.defense_sim import sketch_similarity
    from repro_torch.kernels.fedavg_agg import fedavg_agg
    from repro_torch.kernels.flash_attention import flash_attention

    t_phase = time.perf_counter()
    cfg = get_config("tinyllama-1.1b")
    N, rounds, lr = 4, 4, 0.05
    t0 = time.perf_counter()
    model, fed, data, eval_set = lm_fleet(cfg, N, 24, aggregation="fedar",
                                          defense="foolsgold_sketch")
    params = model.init(torch.Generator(device=DEV).manual_seed(11), DEV)
    dim = sum(t.numel() for _, t in ordered_leaves(params))
    print(f"\n[LM training] tinyllama-1.1b at full width: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype} weights and fp32 norms, D = {dim:,}; "
          f"{N} clients x {data['tokens'].shape[1]} x 64 tokens, fedar + foolsgold_sketch, "
          f"E = {fed.local_epochs}, B = {fed.local_batch_size}, lr {lr}; {smi}")
    fed = dc.replace(fed, timeout=lm_timeout(fed, model, data, dim, rounds))
    server = FedARServer(model, fed, req, lr=lr, device=DEV, init_params=params)
    data_dev = server.engine.device_data(data)
    plain_model = type(model)(cfg, device=DEV, attn_impl="einsum")
    plain = FedARServer(plain_model, dc.replace(fed, agg_impl="einsum",
                                                defense_impl="einsum"),
                        req, lr=lr, device=DEV, init_params=params)
    plain.state = None  # only its engine's step is used, from the kernel route's states
    torch.cuda.synchronize()
    print(f"  set-up (params, corpus, two engines with their sketch tables) "
          f"{time.perf_counter() - t0:.2f} s; card memory in use "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")

    marks = {"set-up": time.perf_counter()}
    timer = PartTimer()
    bad_rows = []

    def training(*args, **kw):
        out = model_update(*args, **kw)
        bad_rows.append((~torch.isfinite(out).all(dim=1)).nonzero().flatten().tolist())
        return out

    model_update = model.client_update
    model.client_update = timer.wrap("training", training)
    model.metrics = timer.wrap("eval", model.metrics)
    sk = server.engine.defense
    sk.sketch = timer.wrap("sketch", sk.sketch)
    agg_fn = agg.fedavg_aggregate
    agg.fedavg_aggregate = timer.wrap("aggregation", agg_fn)
    nb = -(-data["tokens"].shape[1] // fed.local_batch_size)
    tokens = N * fed.local_epochs * nb * fed.local_batch_size * 64
    real = fed.local_epochs * 64 * int(data["sizes"].sum())
    poison = server.poison_mask
    path = (fedavg_agg, sketch_similarity, count_sketch, flash_attention)
    launches = {k.__name__: 0 for k in path}
    for k in every:
        k.launches = 0
    walls, train_s = [], []
    try:
        for r in range(rounds):
            start = server.state
            timer.parts = {}
            before = {k.__name__: k.launches for k in path}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            server.run_round(data_dev, eval_set=eval_set)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            walls.append(wall)
            peak = torch.cuda.max_memory_allocated()
            got = {k.__name__: k.launches - before[k.__name__] for k in path}
            for name, c in got.items():
                launches[name] += c
            parts = dict(timer.parts)
            parts["rest"] = wall - sum(parts.values())
            train_s.append(parts["training"])
            sel = server.history["selected"][r]
            ontime = server.history["on_time"][r] & sel
            split = ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
            print(f"  round {r}: {wall:.3f} s ({split}); training "
                  f"{tokens / parts['training']:,.0f} tokens/s ({real} real of {tokens} "
                  f"a round); selected {np.where(sel)[0].tolist()}, on time "
                  f"{np.where(ontime)[0].tolist()}; held-out loss "
                  f"{server.history['loss'][r]:.4f}, token accuracy "
                  f"{server.history['acc'][r]:.4f}; launches {got}; peak "
                  f"{peak / 2**30:.3f} GiB; non-finite local rows {bad_rows[-1]}")
            for name in ("fedavg_agg", "sketch_similarity", "count_sketch"):
                if got[name] != 1:
                    raise AssertionError(f"round {r}: {name} launched {got[name]} times")
            if got["flash_attention"] != cfg.num_layers:
                raise AssertionError(f"round {r}: the eval launched flash_attention "
                                     f"{got['flash_attention']} times")
            if not (ontime & ~poison).any():
                raise AssertionError(f"round {r}: no honest client arrived in time")
            if bad_rows[-1]:
                raise AssertionError(f"round {r}: the quarantine fired on clients "
                                     f"{bad_rows[-1]} at lr {lr}")
            if not (torch.isfinite(server.state.params).all()
                    and np.isfinite(server.history["loss"][r])):
                raise AssertionError(f"round {r}: the state or the held-out loss is "
                                     "not finite")
            if r > 0:  # round 1 is warm-up; rounds 2-4 against the plain route
                check_round(r, server, plain.engine, data_dev, start, server.state)
            del start
    finally:
        model.client_update = model_update
        agg.fedavg_aggregate = agg_fn
        del model.metrics, sk.sketch
    print(f"  rounds 1-{rounds - 1}: trust, selected and on-time masks identical to the "
          f"plain route (agg_impl = defense_impl = 'einsum') from the same state")
    steady = (rounds - 1) / sum(walls[1:])
    print(f"  steady (rounds 2-{rounds}): {steady:.4f} rounds/s, "
          f"{tokens * (rounds - 1) / sum(train_s[1:]):,.0f} training tokens/s; "
          f"launches in phase 11's {rounds} rounds: {launches}; {smi}")
    if not server.history["loss"][-1] < server.history["loss"][0]:
        print("  (the held-out loss did not fall over these rounds)")

    def one_round():
        server.run_round(data_dev, eval_set=eval_set)
        torch.cuda.synchronize()

    # one more round under torch.profiler: the device's busy and idle share
    # (the profiler slows the host, so the share is also taken against the
    # unprofiled steady round)
    _, busy_ms, _ = profile_device(one_round, ("flash_attention",), profile_dir,
                                   "lm_train_round", unit="round")
    print(f"  device busy {busy_ms:.3f} ms of the steady round's "
          f"{1e3 / steady:.3f} ms: idle share {1 - busy_ms * steady / 1e3:.3f}")

    marks["rounds, route checks and the profiled round"] = time.perf_counter()
    # the path's kernels at its own shapes: the count sketch at D = 1.1e9
    # (bit-equal over ten runs), fedavg_agg at (4, D), sketch_similarity
    # at 4 x 256
    hist = server.state.fg_history
    del server, plain, data_dev, params, model, plain_model
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEV).manual_seed(12)
    rows = torch.randn(N, dim, device=DEV, generator=gen).mul_(0.01)
    print(f"  count_sketch at the path's (4, {dim:,}) deltas:")
    fields = count_sketch_check(sk, rows, f"N={N}, D={dim:,}", reps=5)
    entries["count_sketch"]["phase11"] = dict(launches=launches["count_sketch"], **fields)
    del sk
    w = torch.rand(N, device=DEV, generator=gen)
    got = fedavg_agg(rows, w)
    err = compare(f"fedavg_agg at ({N}, {dim:,}), N x D = {N * dim:,} "
                  f"({'past' if N * dim > 2**31 else 'within'} 2^31)", got,
                  ref.fedavg_agg_ref(rows, w), atol=1e-6, rtol=1e-5)
    k_ms = time_ms(lambda: fedavg_agg(rows, w), reps=5)
    p_ms = time_ms(lambda: ref.fedavg_agg_ref(rows, w), reps=5)
    lib_ms = time_ms(lambda: torch.matmul(w, rows), reps=5)
    b_ms, b_by = bound_ms(4 * (N * dim + N + dim), 2 * N * dim)
    print(f"    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, matmul {lib_ms:.4f} ms, bound "
          f"{b_ms:.4g} ms ({b_by})")
    entries["fedavg_agg"]["phase11"] = dict(
        launches=launches["fedavg_agg"], max_abs_err=err, ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    del rows, got
    unit = hist / torch.clamp(torch.linalg.vector_norm(hist, dim=1, keepdim=True), min=1e-9)
    err = compare("sketch_similarity at the phase's 4 x 256 history",
                  sketch_similarity(unit, unit), ref.sketch_similarity_ref(unit, unit),
                  atol=1e-5, rtol=0.0)
    k_ms = time_ms(lambda: sketch_similarity(unit, unit), reps=20)
    p_ms = time_ms(lambda: ref.sketch_similarity_ref(unit, unit), reps=20)
    lib_ms = time_ms(lambda: torch.matmul(unit, unit.T), reps=20)
    b_ms, b_by = bound_ms(4 * (unit.numel() + N * N), 2 * N * N * unit.shape[1])
    print(f"    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, matmul {lib_ms:.4f} ms, bound "
          f"{b_ms:.3g} ms ({b_by})")
    entries["sketch_similarity"]["phase11"] = dict(
        launches=launches["sketch_similarity"], max_abs_err=err, ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    # flash_attention at the eval's shape: 64 sequences of 64 tokens, 32
    # heads of 64 over 4 kv heads, bf16
    B, S, H, K, hd = 64, 64, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = torch.randn(B, S, H, hd, device=DEV, generator=gen, dtype=torch.bfloat16)
    k, v = (torch.randn(B, S, K, hd, device=DEV, generator=gen, dtype=torch.bfloat16)
            for _ in range(2))
    err = compare_by_row(f"flash_attention at the eval's (B, S, H, K, hd) = "
                         f"{(B, S, H, K, hd)}, bf16", flash_attention(q, k, v),
                         ref.flash_attention_ref(q, k, v), rtol=BF16_RTOL)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    k_ms = time_ms(lambda: flash_attention(q, k, v), reps=20)
    p_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v), reps=20)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=20)
    b_ms, b_by = attn_bound(B, S, H, K, hd, 0, torch.bfloat16)
    print(f"    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library {lib_ms:.4f} ms "
          f"(scaled_dot_product_attention), bound {b_ms:.4f} ms ({b_by})")
    entries["flash_attention"]["phase11"] = dict(
        launches=launches["flash_attention"], max_abs_err=err, ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    del hist, unit, q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    marks["the kernels at the path's shapes"] = time.perf_counter()
    # examples/federated_lm.py's reduced model and fleet, both of its runs
    small = cfg.reduced(num_layers=2, d_model=128, d_ff=256, vocab_size=512)
    for aggregation, defense, kernels in (
            ("async", "foolsgold_sketch", path),
            ("fedavg", "none", (fedavg_agg, flash_attention))):
        model, fed_s, data, eval_set = lm_fleet(small, 8, 24, timeout=10.0,
                                                aggregation=aggregation, defense=defense)
        server = FedARServer(model, fed_s, req, lr=lr, device=DEV)
        plain = FedARServer(type(model)(small, device=DEV, attn_impl="einsum"),
                            dc.replace(fed_s, agg_impl="einsum", defense_impl="einsum"),
                            req, lr=lr, device=DEV, init_params=server.template)
        data_dev = server.engine.device_data(data)
        print(f"\n[LM example] examples/federated_lm.py's fleet: 8 clients, 2 layers, "
              f"d_model 128, vocab 512, {aggregation} + {defense}, 8 rounds")
        _, _, starts = timed_rounds(server, data_dev, eval_set, 8, kernels, every)
        h = server.history
        print(f"  held-out loss {[round(x, 4) for x in h['loss']]}; stragglers a round "
              f"{[int((~o & s).sum()) for o, s in zip(h['on_time'], h['selected'])]}")
        check_each_round(server, plain.engine, data_dev, starts)
        if not (np.isfinite(h["loss"]).all() and torch.isfinite(server.state.params).all()):
            raise AssertionError(f"the example's {aggregation} run is not finite")
        del server, plain, starts, data_dev
    marks["the example's two fleets"] = time.perf_counter()
    t, parts = t_phase, []
    for name, at in marks.items():
        parts.append(f"{name} {at - t:.1f}")
        t = at
    print(f"[phase 11] {time.perf_counter() - t_phase:.1f} s ({', '.join(parts)})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also write torch.profiler tables of one round to DIR")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.fedar_mnist import MnistConfig, fleet_fed
    from repro_torch.core.engine import PackedLayout, flatten, unflatten
    from repro_torch.core.fedar import FedARServer
    from repro_torch.core.resources import TaskRequirement
    from repro_torch.data.datasets import make_federated
    from repro_torch.data.federated import scaled_fleet, table2_fleet
    from repro_torch.data.synthetic import make_digits
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.compress import pack_codes, topk_decode, unpack_codes
    from repro_torch.kernels.count_sketch import count_sketch
    from repro_torch.kernels.defense_sim import sketch_similarity
    from repro_torch.kernels.fedavg_agg import fedavg_agg
    from repro_torch.kernels.flash_attention import flash_attention, tensor_core_attrs
    from repro_torch.kernels.local_sgd import local_sgd, local_sgd_ragged
    from repro_torch.kernels.ssm_scan import kernel_attrs as ssm_attrs
    from repro_torch.kernels.ssm_scan import plan as ssm_plan
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = (local_sgd, fedavg_agg, sketch_similarity)
    # the round's kernels with the defense's count sketch (every fleet here
    # runs foolsgold_sketch)
    sketched = kernels + (count_sketch,)
    codecs = (pack_codes, unpack_codes, topk_decode)
    packed_kernels = (local_sgd_ragged, fedavg_agg, sketch_similarity, count_sketch)
    lm_kernels = (flash_attention, ssm_scan)
    every = sketched + codecs + (local_sgd_ragged,) + lm_kernels

    # --- phase 1: environment and build
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lib = ops.library()
    print(f"[setup] kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "error" in line or "warning" in line:
            print(f"  {line.strip()}")

    # --- phase 2: each kernel vs its plain version on the card
    fleet = table2_fleet()
    entries = kernel_phase(ref, kernels, fleet)
    entries.update(codec_phase(ref, codecs))
    # phase 7's fleet on both layouts, for the ragged kernel's check; moved
    # to the card again in phase 7, so that phases 3-6 measure their peak
    # memory without it
    req = TaskRequirement()
    t0 = time.perf_counter()
    skew = make_federated("digits", 512, scenario="quantity_skew",
                          samples_per_client=200, seed=7)
    fed_gated = fleet_fed(512, defense="foolsgold_sketch", select_frac=0.5)
    gated = FedARServer(MnistConfig(), fed_gated, req, device=DEV)

    def prepare_skew():
        packed = gated.engine.prepare_data(skew)
        if not isinstance(packed["packed"], PackedLayout):
            raise AssertionError("prepare_data did not pick the packed layout for "
                                 "the quantity-skewed fleet")
        return packed, gated.engine.prepare_data(skew, layout="dense")

    skew_packed, skew_dense = prepare_skew()
    torch.cuda.synchronize()
    lay = skew_packed["packed"]
    sizes = skew.sizes
    print(f"\n[set-up] quantity_skew fleet: 512 clients, {int(sizes.sum())} samples, "
          f"sizes {int(sizes.min())}-{int(sizes.max())} (median {np.median(sizes):g}), "
          f"n_max {skew.samples}; packed: {len(lay.buckets)} buckets, "
          f"{lay.tile_mask.shape[0]} tiles against {512 * -(-skew.samples // 20)} for "
          f"the rectangle; built and moved in {time.perf_counter() - t0:.2f} s")
    entries["local_sgd_ragged"] = ragged_phase(ref, local_sgd_ragged, local_sgd,
                                               lay, skew_dense)
    del skew_packed, skew_dense, lay
    # phase 9's shapes: zamba2-7b's shared block (32 heads of 112, no kv
    # grouping) over 4 x 2,048 tokens and over one 8,192-token prompt (bf16
    # only: its plain version's fp32 score block is 8.6 GB), the same with
    # a 512 window (the local layers of gemma-style configs),
    # tinyllama-1.1b's (32 heads of 64 over 4 kv heads); zamba2-7b's SSD
    # (112 heads of 64, state 64) over the same two prompt shapes
    zamba = get_config("zamba2-7b")
    both = (torch.bfloat16, torch.float32)
    entries.update(lm_kernel_phase(
        ref, flash_attention, tensor_core_attrs, (ssm_scan, ssm_attrs, ssm_plan),
        [("zamba2-7b", 4, 2048, 32, 32, 112, 0, both),
         ("zamba2-7b, one long prompt", 1, 8192, 32, 32, 112, 0, both[:1]),
         ("zamba2-7b, window 512", 4, 2048, 32, 32, 112, 512, both),
         ("tinyllama-1.1b", 1, 2048, 32, 4, 64, 0, both)],
        [("zamba2-7b", 4, 2048, 112, 64, 64, both),
         ("zamba2-7b, one long prompt", 1, 8192, 112, 64, 64, both[:1])],
        zamba.ssm_chunk))
    torch.cuda.empty_cache()

    # --- phase 3: the main path, 12 robots at full width
    fed = fleet_fed(12, defense="foolsgold_sketch")
    eval_set = make_digits(500, seed=99)
    rounds = 5
    server = FedARServer(MnistConfig(), fed, req, device=DEV)
    data = server.engine.device_data(fleet)
    print("\n[main path] 12 robots, 784 -> 128 -> 10, fedar + foolsgold_sketch")
    _, launches, _ = timed_rounds(server, data, eval_set, rounds, sketched, every)
    hist = server.history
    print("round  acc     loss    selected  trust")
    for r in range(rounds):
        print(f"{r:5d}  {hist['acc'][r]:.4f}  {hist['loss'][r]:.4f}  "
              f"{int(hist['selected'][r].sum()):8d}  {hist['trust'][r].tolist()}")
    for name, count in launches.items():
        entries[name]["launches"] = count
    params = server.state.params
    if not torch.isfinite(params).all() or params.shape != (server.dim,):
        raise AssertionError("main path produced non-finite or misshapen params")
    if not hist["acc"][-1] > 0.5:
        raise AssertionError(f"accuracy after {rounds} rounds is {hist['acc'][-1]}")

    def plain_route(f):
        return dataclasses.replace(f, sgd_impl="einsum", agg_impl="einsum",
                                   defense_impl="einsum")

    plain = FedARServer(MnistConfig(), plain_route(fed), req, device=DEV)
    t0 = time.perf_counter()
    plain.run(data, rounds=rounds, eval_set=eval_set)
    torch.cuda.synchronize()
    print(f"[plain route] {rounds} rounds in {time.perf_counter() - t0:.3f} s")
    check_routes(server, plain, steps=rounds * 250)
    if args.profile:
        profile_round(server, data, eval_set, Path(args.profile), "n12")

    # --- phase 4: scale, 512 clients; round 1 is warm-up, 2-6 are timed
    t0 = time.perf_counter()
    big = scaled_fleet(512, samples_per_client=200)
    print(f"\n[scale] 512 clients x 200 samples built in "
          f"{time.perf_counter() - t0:.2f} s (set-up)")
    fed512 = fleet_fed(512, defense="foolsgold_sketch")
    rounds512 = 6
    server = FedARServer(MnistConfig(), fed512, req, device=DEV)
    big_dev = server.engine.device_data(big)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, _, starts = timed_rounds(server, big_dev, eval_set, rounds512, sketched, every)
    print(f"acc {[round(a, 4) for a in server.history['acc']]}")
    print(f"max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not torch.isfinite(server.state.params).all():
        raise AssertionError("512-client run produced non-finite params")
    # local_sgd at this path's shape (R = 512, n = 200) against its plain
    # version, from the run's initial global params (fedavg_agg at N = 512
    # and sketch_similarity at 512 x 256 are held in phase 2)
    g0 = starts[0].params
    sgd_args = (big_dev["x"], big_dev["y"], big_dev["activations"],
                torch.ones(big_dev["y"].shape, dtype=torch.bool, device=DEV))
    sgd_kw = dict(hidden=128, classes=10, lr=0.1, batch_size=20, epochs=5)
    want = ref.local_sgd_ref(g0, *sgd_args, **sgd_kw)
    compare_rows("local_sgd at R=512, n=200 vs plain",
                 local_sgd(g0, *sgd_args, **sgd_kw), want,
                 atol=1e-4, rtol=1e-4, kink_atol=2e-3)
    other = server.engine.model.client_update(
        unflatten(g0, server.template),
        {k: big_dev[k] for k in ("x", "y", "activations")}, lr=0.1,
        batch_size=20, epochs=5)
    spread = (flatten(other, rows=True) - want).abs().amax(dim=1)
    print(f"  the two plain versions (autograd vs ref) on the same inputs: "
          f"max_abs_err={spread.max().item():.3e}, "
          f"{int((spread > 1e-6).sum().item())} rows over 1e-6")
    plain = FedARServer(MnistConfig(), plain_route(fed512), req, device=DEV)
    check_each_round(server, plain.engine, big_dev, starts)

    g = server.state.params
    sgd_ms = time_ms(lambda: local_sgd(g, *sgd_args, **sgd_kw), reps=3)
    sgd_plain_ms = time_ms(lambda: ref.local_sgd_ref(g, *sgd_args, **sgd_kw), reps=3)
    xb, yb, ab, mb = sgd_args
    sgd_bound, sgd_by = bound_ms(
        4 * (xb.numel() + yb.numel() + mb.numel() + ab.numel()
             + server.dim * (1 + xb.shape[0])),
        sgd_flops(mb, 20, 784, 128, 10, 5))
    deltas = (torch.randn(512, server.dim) * 0.01).to(DEV)
    w = torch.rand(512).to(DEV)
    agg_ms = time_ms(lambda: fedavg_agg(deltas, w), reps=10)
    unit = server.state.fg_history
    unit = unit / torch.clamp(torch.linalg.vector_norm(unit, dim=1, keepdim=True), min=1e-9)
    sim_ms = time_ms(lambda: sketch_similarity(unit, unit), reps=10)
    print(f"per-round kernel ms at 512 clients: local_sgd {sgd_ms:.3f} (plain "
          f"{sgd_plain_ms:.3f}, bound {sgd_bound:.3g} ({sgd_by})), fedavg_agg "
          f"{agg_ms:.4f}, sketch_similarity {sim_ms:.4f}")
    if args.profile:
        profile_round(server, big_dev, eval_set, Path(args.profile), "n512")

    # --- phase 5: buffered async + 4-bit QSGD, 512 clients at full width
    fed_async = fleet_fed(512, aggregation="async", compress="qsgd", compress_bits=4,
                          defense="foolsgold_sketch")
    force = torch.as_tensor(np.arange(512) % 10 == 0, device=DEV)  # 52 clients, lag 3
    print(f"\n[async + qsgd-4] 512 clients, {int(force.sum())} forced stragglers, "
          f"foolsgold_sketch")
    server = FedARServer(MnistConfig(), fed_async, req, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, launches5, starts = timed_rounds(
        server, big_dev, eval_set, rounds512, sketched + codecs[:2], every, force)
    st = server.state
    print(f"acc {[round(a, 4) for a in server.history['acc']]}")
    print(f"max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"buffer: {int(st.pending_valid.sum())} slots in flight; residual L2 "
          f"{torch.linalg.vector_norm(st.compress_residual).item():.6f}")
    for t in (st.params, st.pending_delta, st.compress_residual):
        if not torch.isfinite(t).all():
            raise AssertionError("async + qsgd run produced non-finite state")
    if int(st.pending_issued.max()) == 0 or not (st.compress_residual != 0).any():
        raise AssertionError("the async buffer or the residual never moved")
    plain = FedARServer(MnistConfig(), dataclasses.replace(fed_async, compress_impl="einsum"),
                        req, device=DEV)
    check_codec_routes(server.engine, plain.engine, big_dev, starts, force)
    g = st.params
    w = torch.where(st.pending_valid, st.pending_weight, 0.0)
    tau = torch.clamp(server.round_idx - st.pending_issued, min=0).to(torch.float32)
    agg_ms = time_ms(lambda: fedavg_agg(st.pending_delta, w, staleness=tau), reps=10)
    unit = st.fg_history
    unit = unit / torch.clamp(torch.linalg.vector_norm(unit, dim=1, keepdim=True), min=1e-9)
    sim_ms = time_ms(lambda: sketch_similarity(unit, unit), reps=10)
    sgd_ms = time_ms(lambda: local_sgd(g, *sgd_args, **sgd_kw), reps=3)
    print(f"per-round kernel ms in this phase: local_sgd {sgd_ms:.3f}, fedavg_agg "
          f"(pending buffer, with staleness) {agg_ms:.4f}, sketch_similarity {sim_ms:.4f}")
    if args.profile:
        profile_round(server, big_dev, eval_set, Path(args.profile), "n512_async_qsgd4",
                      force=force)
    for name in ("pack_codes", "unpack_codes"):
        entries[name]["launches"] = launches5[name]

    # --- phase 6: top-k at full width, 12 robots, then 512 clients
    fed_topk = fleet_fed(12, compress="topk", defense="foolsgold_sketch")
    print("\n[fedar + topk] 12 robots, k = D // 32")
    server = FedARServer(MnistConfig(), fed_topk, req, device=DEV)
    print(f"k = {server.engine.compression.k}")
    _, launches6, starts = timed_rounds(
        server, data, eval_set, rounds, sketched + codecs[2:], every)
    print(f"acc {[round(a, 4) for a in server.history['acc']]}")
    if not torch.isfinite(server.state.params).all():
        raise AssertionError("topk run produced non-finite params")
    if not server.history["acc"][-1] > 0.5:
        raise AssertionError(f"topk accuracy after {rounds} rounds is "
                             f"{server.history['acc'][-1]}")
    plain = FedARServer(MnistConfig(), dataclasses.replace(fed_topk, compress_impl="einsum"),
                        req, device=DEV)
    check_codec_routes(server.engine, plain.engine, data, starts, None)
    if args.profile:
        profile_round(server, data, eval_set, Path(args.profile), "n12_topk", topk=True)

    # the same at 512 clients: phase 4's fleet, 6 rounds (round 1 warm-up)
    fed_topk512 = fleet_fed(512, compress="topk", defense="foolsgold_sketch")
    print("\n[fedar + topk] 512 clients, k = D // 32")
    server = FedARServer(MnistConfig(), fed_topk512, req, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, launches6, starts = timed_rounds(
        server, big_dev, eval_set, rounds512, sketched + codecs[2:], every)
    if launches6["topk_decode"] != 2 * rounds512:
        raise AssertionError(f"topk_decode launched {launches6['topk_decode']} times in "
                             f"{rounds512} rounds, not 2 a round")
    st = server.state
    print(f"acc {[round(a, 4) for a in server.history['acc']]}")
    print(f"max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"residual L2 {torch.linalg.vector_norm(st.compress_residual).item():.6f}")
    for t in (st.params, st.compress_residual):
        if not torch.isfinite(t).all():
            raise AssertionError("512-client topk run produced non-finite state")
    plain = FedARServer(MnistConfig(),
                        dataclasses.replace(fed_topk512, compress_impl="einsum"),
                        req, device=DEV)
    check_codec_routes(server.engine, plain.engine, big_dev, starts, None)
    entries["topk_decode"]["launches"] = launches6["topk_decode"]
    if args.profile:
        profile_round(server, big_dev, eval_set, Path(args.profile), "n512_topk",
                      topk=True)

    # --- phase 7: gated packed at full width, 512 quantity-skewed clients
    skew_packed, skew_dense = prepare_skew()
    lay = skew_packed["packed"]
    print("\n[gated packed] 512 clients, quantity_skew, select_frac=0.5, "
          f"cohort cap {gated.engine.cohort_cap}, fedar + foolsgold_sketch")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times7, launches7, starts = timed_rounds(gated, skew_packed, eval_set, rounds512,
                                             packed_kernels, every)
    peak7 = torch.cuda.max_memory_allocated()
    for name, count in launches7.items():
        if count != rounds512:
            raise AssertionError(f"{name} launched {count} times in {rounds512} rounds")
    if local_sgd.launches != 0:
        raise AssertionError("the dense local_sgd kernel launched on the packed path")
    print(f"acc {[round(a, 4) for a in gated.history['acc']]}; selected per round "
          f"{[int(m.sum()) for m in gated.history['selected']]}")
    print(f"max_memory_allocated: {peak7 / 2**30:.3f} GiB (resident before the "
          f"run, both layouts of the fleet: {resident / 2**30:.3f} GiB)")
    if not torch.isfinite(gated.state.params).all():
        raise AssertionError("gated packed run produced non-finite params")
    plain = FedARServer(MnistConfig(), plain_route(fed_gated), req, device=DEV)
    check_each_round(gated, plain.engine, skew_packed, starts)
    fed_dense = fleet_fed(512, defense="foolsgold_sketch")
    dense = FedARServer(MnistConfig(), fed_dense, req, device=DEV)
    check_against_dense(gated, dense.engine, skew_dense, starts)
    # the kernel at the main path's own call: this round's cohort rows
    g = gated.state.params
    sel = torch.as_tensor(gated.history["selected"][-1], device=DEV)
    desc = lay.desc_rows
    sel_d = sel[lay.perm[desc]] & lay.valid[desc]
    rows = desc[torch.argsort((~sel_d).to(torch.int32), stable=True)[:gated.engine.cohort_cap]]
    call = (lay.tiles["x"], lay.tiles["y"], lay.tile_mask, lay.act[rows], lay.nb[rows],
            lay.off[rows])
    kw = dict(hidden=128, classes=10, lr=0.1, epochs=5)
    c_ms = time_ms(lambda: local_sgd_ragged(g, *call, **kw), reps=3)
    c_plain = time_ms(lambda: ref.local_sgd_ragged_ref(g, *call, **kw), reps=2)
    c_bound, c_by = ragged_bound(lay, lay.tile_mask, rows, gated.dim, 128, 10, 5)
    print(f"local_sgd_ragged at the cohort's {rows.numel()} rows (batch counts up to "
          f"{int(lay.nb[rows].max())}): kernel {c_ms:.3f} ms, plain {c_plain:.3f} ms, "
          f"bound {c_bound:.3g} ms ({c_by})")
    entries["local_sgd_ragged"]["launches"] = launches7["local_sgd_ragged"]
    if args.profile:
        profile_round(gated, skew_packed, eval_set, Path(args.profile),
                      "n512_gated_packed")

    print("\n[dense ungated] the same fleet on the (512, 1394) rectangle, no gating")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times7d, _, _ = timed_rounds(dense, skew_dense, eval_set, rounds512, sketched, every)
    peak7d = torch.cuda.max_memory_allocated()
    print(f"max_memory_allocated: {peak7d / 2**30:.3f} GiB (resident before the "
          f"run: {resident / 2**30:.3f} GiB)")
    print(f"steady rounds/s (rounds 2-{rounds512}): gated packed "
          f"{(rounds512 - 1) / sum(times7[1:]):.3f}, dense ungated "
          f"{(rounds512 - 1) / sum(times7d[1:]):.3f}")
    if args.profile:
        profile_round(dense, skew_dense, eval_set, Path(args.profile),
                      "n512_skew_dense")
    del skew_dense, dense

    # --- phase 8: drift windows on the packed layout, 64 clients
    drift = make_federated("digits", 64, scenario="robot_drift",
                           samples_per_client=200, seed=7)
    fed_drift = fleet_fed(64, defense="foolsgold_sketch")
    server = FedARServer(MnistConfig(), fed_drift, req, device=DEV)
    drift_packed = server.engine.prepare_data(drift, layout="packed")
    W = drift_packed["packed"].tile_round_mask.shape[0]
    print(f"\n[drift, packed] 64 clients, robot_drift with {W} windows, "
          f"fedar + foolsgold_sketch, {W} rounds")
    _, _, starts = timed_rounds(server, drift_packed, eval_set, W, packed_kernels, every)
    print(f"acc {[round(a, 4) for a in server.history['acc']]}")
    if not torch.isfinite(server.state.params).all():
        raise AssertionError("drift run produced non-finite params")
    plain = FedARServer(MnistConfig(), plain_route(fed_drift), req, device=DEV)
    check_each_round(server, plain.engine, drift_packed, starts)
    if args.profile:
        profile_round(server, drift_packed, eval_set, Path(args.profile),
                      "n64_drift_packed")

    # phases 3-8's fleets, engines and the tensors kept for their checks
    del (fleet, data, big, big_dev, skew, skew_packed, lay, drift_packed, server, plain,
         gated, starts, sgd_args, xb, yb, ab, mb, want, other, spread, deltas, w, tau,
         unit, st, g, sel, desc, sel_d, rows, call)
    torch.cuda.empty_cache()

    # --- phase 9: serving prefill, zamba2-7b at full width and depth
    print(f"\n[serve prefill] zamba2-7b, {zamba.num_layers} layers, d_model "
          f"{zamba.d_model}, {zamba.dtype}; card memory in use before: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    profile_dir = Path(args.profile) if args.profile else None
    launches9, model, params = serve_phase(
        zamba, lm_kernels, every, [(4, 2048)] * 4 + [(1, 8192)], 6_750_498_384, profile_dir)
    for name, count in launches9.items():
        entries[name]["launches"] = count

    # --- phase 9b: serving decode in bf16 at full width on phase 9's params
    # and on tinyllama-1.1b's; after phase 9's fp32 route check, decode
    # against prefill block by block on its fp32 model
    t9b = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(4)
    serve_decode(model, params, (4, 1), every, gen, profile_dir)
    del model, params
    torch.cuda.empty_cache()
    model = Model(get_config("tinyllama-1.1b"))
    params = model.init_params(torch.Generator(device=DEV).manual_seed(5))
    serve_decode(model, params, (4,), every, gen, profile_dir)
    del model, params
    torch.cuda.empty_cache()
    t9b = time.perf_counter() - t9b

    model, params = route_phase(zamba, lm_kernels, (1, 1024))
    t0 = time.perf_counter()
    decode_checks(model, params, every, gen)
    del model, params
    torch.cuda.empty_cache()
    t9b += time.perf_counter() - t0
    print(f"[phase 9b] {t9b:.1f} s (decode runs and checks, set-up included)")

    # --- phase 10: the host-store cohort engine, chaos faults, checkpoints
    cohort_phase(req, eval_set, sketched, codecs, every, ref, local_sgd, entries)

    # --- phase 11: federated LM training, tinyllama-1.1b at full width
    lm_train_phase(req, every, entries, smi, profile_dir)

    order = ("local_sgd", "fedavg_agg", "sketch_similarity", "local_sgd_ragged",
             "pack_codes", "unpack_codes", "topk_decode", "flash_attention", "ssm_scan",
             "count_sketch")
    print(smi)
    print(json.dumps({"kernels": [entries[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
