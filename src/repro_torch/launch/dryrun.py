"""Production-mesh dry run: for every (arch x input-shape x mesh), check on
PyTorch's ``meta`` device that the step traces at full width and depth, and
count what one device of the production mesh would hold and compute.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k [--multi-pod] [--out out.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun_all.jsonl

The reference lowers and compiles each step with XLA against a 512-device
placeholder mesh and reads its cost analysis and the collectives of the
partitioned HLO.  The port has no compiler and no SPMD partitioner: it
traces the step on ``meta`` tensors (shapes and dtypes, no data, nothing
allocated) and records
  * the param count, and the per-device bytes of params, optimizer state
    and batch (decode: and cache) under the sharding policy
    (``sharding.py``), each leaf's bytes over the devices its spec shards
    it across;
  * FLOPs a step, counted by ``torch.utils.flop_counter.FlopCounterMode``
    over the traced step (forward, and backward for a train shape, with
    remat's recompute) on the whole global batch, and per device as that
    over the mesh's device count;
  * ``t_compute`` = per-device FLOPs / the H100's dense bf16 peak and
    ``t_memory`` = per-device bytes / its HBM bandwidth (``mesh.py``): the
    least time a card could take to compute the step and to read its
    state once.
``collective_bytes`` is null: without HLO there are no collectives to
read.  Nothing here runs on a card, and no number here is a measurement.

The sLSTM is one Python step a position (``models/xlstm.py``), so
xlstm-350m at ``prefill_32k`` traces ~7.6 M meta ops: ``--all`` is a slow
command-line run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.common.config import INPUT_SHAPES, TrainConfig
from repro_torch.configs import ARCH_IDS, cfg_for_shape, get_config
from repro_torch.launch import sharding
from repro_torch.launch.input_specs import abstract_params, input_specs
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, make_production_mesh
from repro_torch.launch.train import TrainState, build_train_step
from repro_torch.models.model import Model, param_count
from repro_torch.optim.optimizers import make_optimizer


def build_abstract_state(model: Model, tc: TrainConfig) -> TrainState:
    params = abstract_params(model.cfg)
    return TrainState(params, make_optimizer(tc).init(params), 0)


def device_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` under ``specs`` (a spec tree of
    the same structure): each leaf's bytes over the product of the mesh
    axes its spec shards it along."""
    if isinstance(tree, dict):
        return sum(device_bytes(tree[k], specs[k], mesh) for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(device_bytes(t, s, mesh) for t, s in zip(tree, specs, strict=True))
    axes = [a for e in specs if e is not None for a in (e if isinstance(e, tuple) else (e,))]
    return tree.numel() * tree.element_size() // math.prod(mesh.axis_size(a) for a in axes)


def _flops(fn) -> float:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops())


def _records(cfg, arch, shape_name, meshes, *, tc, policy="fsdp_tp"):
    """The dry-run records of one (config, shape), one for each mesh
    (``multi_pod`` flag) in ``meshes``: the step is traced once, since its
    FLOPs do not depend on the mesh; the bytes a device holds do."""
    shape = INPUT_SHAPES[shape_name]
    model = Model(cfg, "meta")

    t0 = time.time()
    inp = input_specs(cfg, shape)
    opt_state, cache = None, None
    if shape.kind == "train":
        state = build_abstract_state(model, tc)
        params, opt_state, batch = state.params, state.opt_state, inp
        step_fn = build_train_step(model, tc)
        flops = _flops(lambda: step_fn(state, inp))
    elif shape.kind == "prefill":
        params, batch = abstract_params(cfg), inp
        flops = _flops(lambda: model.prefill(params, inp))
    else:
        params, batch, cache = abstract_params(cfg), {"tokens": inp["tokens"]}, inp["cache"]
        flops = _flops(lambda: model.decode_step(params, cache, inp["tokens"], inp["pos"]))
    trace_s = time.time() - t0

    records = []
    for multi_pod in meshes:
        mesh = make_production_mesh(multi_pod=multi_pod)
        param_bytes = device_bytes(params, sharding.param_specs(params, mesh, policy=policy),
                                   mesh)
        opt_bytes = (0 if opt_state is None else device_bytes(
            opt_state, sharding.param_specs(opt_state, mesh, policy=policy), mesh))
        batch_bytes = device_bytes(batch, sharding.batch_specs(batch, mesh), mesh)
        cache_bytes = (None if cache is None else
                       device_bytes(cache, sharding.cache_specs(cache, mesh), mesh))
        state_bytes = param_bytes + opt_bytes + batch_bytes + (cache_bytes or 0)
        flops_dev = flops / mesh.size
        records.append({
            "arch": arch,
            "shape": shape_name,
            "mesh": "x".join(map(str, mesh.shape)),
            "multi_pod": multi_pod,
            "chips": mesh.size,
            "kind": shape.kind,
            "policy": policy,
            "trace_s": round(trace_s, 2),
            "params": param_count(params),
            "param_bytes": param_bytes,
            "opt_state_bytes": opt_bytes,
            "batch_bytes": batch_bytes,
            "cache_bytes": cache_bytes,
            "flops": flops,
            "flops_per_device": flops_dev,
            "collective_bytes": None,
            "t_compute": flops_dev / PEAK_FLOPS_BF16,
            "t_memory": state_bytes / HBM_BW,
        })
    return records


def _default_tc(cfg) -> TrainConfig:
    return TrainConfig(optimizer="sgd", lr=1e-2, remat=True,
                       loss_chunk=512 if cfg.vocab_size > 100_000 else 0)


def _lower(arch, shape_name, meshes, tc=None):
    cfg = cfg_for_shape(get_config(arch), INPUT_SHAPES[shape_name])
    return _records(cfg, arch, shape_name, meshes, tc=tc or _default_tc(cfg))


def lower_one(arch, shape_name, *, multi_pod=False, tc=None, extra_tags=None):
    """Trace one (arch, shape, mesh) on ``meta`` and return the record."""
    record = _lower(arch, shape_name, [multi_pod], tc)[0]
    if extra_tags:
        record.update(extra_tags)
    return record


def pattern_period(cfg) -> int:
    """Smallest repeating block-pattern unit (layers)."""
    if cfg.shared_attn_every:
        return cfg.shared_attn_every
    if cfg.global_every:
        return cfg.global_every
    if "s" in cfg.block_pattern:
        return 2  # xlstm (sLSTM, mLSTM) pair
    return 1


def roofline_one(arch, shape_name, *, multi_pod=False, tc=None,
                 policy="fsdp_tp", cfg_over=None):
    """Roofline terms at full depth.

    The reference compiles unrolled one- and two-period variants and
    extrapolates to L layers, because XLA's cost analysis counts a scan
    body once.  The port's layers are a Python loop, and the FLOP counter
    sees every layer of the full-depth trace, so no extrapolation is
    needed: this is ``lower_one`` under ``policy`` (and ``cfg_over``),
    without remat (the reference's roofline mode)."""
    cfg = cfg_for_shape(get_config(arch), INPUT_SHAPES[shape_name])
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    tc = tc or dataclasses.replace(_default_tc(cfg), remat=False, unroll=True)
    rec = _records(cfg, arch, shape_name, [multi_pod], tc=tc, policy=policy)[0]
    rec.update(roofline_mode="full_depth", period=pattern_period(cfg))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--roofline", action="store_true",
                    help="full-depth roofline records without remat (see roofline_one)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    # roofline table is single-pod only (the multi-pod pass checks sharding)
    if args.roofline and not args.both_meshes:
        meshes = [args.multi_pod]
    else:
        meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    ok = True
    sink = open(args.out, "a") if args.out else None
    try:
        for arch in archs:
            for shape in shapes:
                try:
                    if args.roofline:
                        recs = [roofline_one(arch, shape, multi_pod=mp) for mp in meshes]
                    else:
                        recs = _lower(arch, shape, meshes)
                    status = "OK"
                except Exception as e:  # one combination's failure is its record
                    recs = [{"arch": arch, "shape": shape, "multi_pod": mp,
                             "error": f"{type(e).__name__}: {e}"[:500]} for mp in meshes]
                    status = "FAIL"
                    ok = False
                for rec in recs:
                    if sink:
                        sink.write(json.dumps(rec) + "\n")
                        sink.flush()
                    tail = (f" params={rec['params']:,} flops={rec['flops']:.4g} "
                            f"t_compute={rec['t_compute']:.4g}s "
                            f"t_memory={rec['t_memory']:.4g}s trace={rec['trace_s']}s"
                            if status == "OK" else f" {rec.get('error', '')[:200]}")
                    print(f"[{status}] {arch} x {shape} multi_pod={rec['multi_pod']}" + tail,
                          flush=True)
    finally:
        if sink:
            sink.close()
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
