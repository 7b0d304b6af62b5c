"""Training driver: plain data-parallel LM pre-training for any --arch.

Runs REAL steps (reduced or full config) on one device: the card unless
``--device cpu`` is given (without a card that raises, as every entry point
of the port does).  The production-mesh layout is checked by ``dryrun.py``.
Federated behaviour -- trust scoring, straggler masking, buffered async
aggregation, defenses -- lives in ``core.engine.FedAREngine`` (see
``examples/federated_lm_torch.py`` for the LM workload through the engine).
Example:

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --steps 50 --batch 8 --seq 128 --ckpt out.pt --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Any, NamedTuple

import torch

from repro_torch.common.config import TrainConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.engine import ordered_leaves, with_leaves
from repro_torch.data.pipeline import lm_batches
from repro_torch.models.model import Model, param_count
from repro_torch.optim.optimizers import apply_updates, make_optimizer
from repro_torch.optim.schedule import make_schedule


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def build_train_step(model: Model, tc: TrainConfig):
    """Returns ``step(state, batch) -> (state, metrics)``: one synchronous
    optimizer step on the causal-LM loss (``Model.loss``, the plain
    attention and scan routes), its gradient by ``torch.autograd.grad``,
    ``opt.update`` and ``apply_updates``.  The learning rate follows
    ``make_schedule(tc)``; the reference's step takes ``tc.lr`` whatever
    ``tc.schedule`` says, and the two agree for the default constant
    schedule.  The metrics are detached 0-d tensors (reading one waits for
    the device)."""
    opt = make_optimizer(tc, make_schedule(tc))

    def step(state: TrainState, batch):
        leaves = [leaf.detach().requires_grad_(True)
                  for _, leaf in ordered_leaves(state.params)]
        with torch.enable_grad():
            loss, parts = model.loss(with_leaves(state.params, leaves), batch,
                                     remat=tc.remat, loss_chunk=tc.loss_chunk)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach has a zero gradient, as under jax.grad
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        grads = with_leaves(state.params, grads)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, state.opt_state, state.params,
                                            state.step)
            params = apply_updates(state.params, updates)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}
        return TrainState(params, opt_state, state.step + 1), metrics

    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, args.device)
    tc = TrainConfig(optimizer=args.optimizer, lr=args.lr, remat=True)

    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init_params(gen)
    opt = make_optimizer(tc)
    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    print(f"arch={cfg.name} params={param_count(params):,} device={model.device}")

    step_fn = build_train_step(model, tc)

    batches = lm_batches(cfg, batch=args.batch, seq=args.seq,
                         steps=args.steps, seed=args.seed)
    t0 = time.time()
    for i, batch in enumerate(batches):
        batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
        state, m = step_fn(state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(
                f"step {i:4d} loss {float(m['loss']):.4f} "
                f"nll {float(m['nll']):.4f} "
                f"({time.time() - t0:.1f}s)"
            )
    if args.ckpt:
        from repro_torch.checkpoint.ckpt import save

        save(args.ckpt, state.params, step=state.step)
        print(f"checkpoint written to {args.ckpt}")
    return state


if __name__ == "__main__":
    main()
