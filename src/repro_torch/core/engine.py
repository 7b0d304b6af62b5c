"""The FedAR round engine (Algorithm 2), resident on one device.

Each communication round runs, in order: CheckResource and trust-sorted
selection, ClientUpdate (E epochs of local SGD for every client of the
fleet; non-participants are masked out of the aggregate), virtual latency
and the straggler mask, the always-on non-finite quarantine, the deviation
ban, the defense weights, aggregation, and the Algorithm 1 trust and
battery updates.  Where the reference scans rounds inside one XLA program,
``run`` is a Python loop over ``step``.

Carried state (``EngineState``) -> Algorithm 2 of the paper:

  ``params``      global model w_i, one flat (D,) float32 vector
  ``trust``       trust scores C_m + the participation / failure counters
  ``resources``   per-robot (M, B, E, F); battery drains with participation
  ``fg_history``  defense history block (N, d): d = D for dense FoolsGold,
                  the sketch width r for ``foolsgold_sketch``, 0 without
  ``round_idx``   the round counter i

Per-round outputs (``RoundOutputs``): post-update trust, the selected and
on-time masks, virtual round time, and eval loss/accuracy.

The three kernels of the round run on the card through the routing knobs
``FedConfig.sgd_impl`` (local SGD), ``agg_impl`` (aggregation) and
``defense_impl`` (the similarity block); see ``kernels/ops.resolve_impl``.
The engine runs on ``cuda`` unless the caller passes ``device="cpu"``, and
raises when there is no CUDA device: it never falls back to the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from repro_torch.common.config import FedConfig
from repro_torch.configs.fedar_mnist import MnistConfig
from repro_torch.convert import GeneratorDraws
from repro_torch.core import aggregation as agg
from repro_torch.core.defense import make_defense
from repro_torch.core.resources import (
    ResourceState,
    TaskRequirement,
    drain_battery,
    make_fleet,
    round_latency,
)
from repro_torch.core.selection import select_clients
from repro_torch.core.trust import TrustState, init_trust, update_trust
from repro_torch.kernels.ops import resolve_impl
from repro_torch.models.client import ClientModel
from repro_torch.models.mnist import MnistClientModel


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without a CUDA device that raises: the CPU
    is used only when the caller asks for it.  On the card, float32 matrix
    products and convolutions are kept out of TF32."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                'device="cpu" to run on the CPU'
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def flatten(params, rows: bool = False) -> torch.Tensor:
    """Param dict -> flat (D,) aggregation-boundary vector, leaves in sorted
    key order (``b1, b2, w1, w2`` for the MLP).  ``rows=True`` flattens a
    dict of stacked (R, ...) leaves to (R, D)."""
    keys = sorted(params)
    if rows:
        return torch.cat([params[k].reshape(params[k].shape[0], -1) for k in keys], 1)
    return torch.cat([params[k].reshape(-1) for k in keys])


def unflatten(flat, template) -> dict:
    """Flat (D,) vector -> dict shaped (and typed) like ``template``."""
    out, off = {}, 0
    for k in sorted(template):
        leaf = template[k]
        n = leaf.numel()
        out[k] = flat[off:off + n].reshape(leaf.shape).to(leaf.dtype)
        off += n
    return out


class EngineState(NamedTuple):
    """Every piece of server state Algorithm 2 mutates."""

    params: torch.Tensor  # (D,) flat global model
    trust: TrustState  # (N,) score / participations / failures
    resources: ResourceState  # (N,) memory / bandwidth / battery / compute
    fg_history: torch.Tensor  # (N, d) defense history
    round_idx: int  # communication round i


class RoundOutputs(NamedTuple):
    """One round's history row (stacked over rounds by ``run``)."""

    trust: torch.Tensor  # (N,) post-update trust scores
    selected: torch.Tensor  # (N,) bool participant mask M_m
    on_time: torch.Tensor  # (N,) bool arrived within timeout t
    round_time: torch.Tensor  # () virtual seconds this round cost
    loss: torch.Tensor  # () eval loss (nan when no eval set)
    acc: torch.Tensor  # () eval accuracy (nan when no eval set)


# data keys a later slice reads, with the ROADMAP item that ports them
_LATER_DATA_KEYS = {
    "packed": "Queue 1 item 8 (packed layout)",
    "round_mask": "Queue 1 item 8 (drift windows)",
    "cohort_valid": "Queue 1 item 11 (cohort engine)",
}


def _check_slice(fed: FedConfig) -> None:
    """Reject the features a later port slice brings, naming its item."""
    later = []
    if fed.aggregation in ("async", "async_seq"):
        later.append(f"aggregation={fed.aggregation!r}: Queue 1 item 7")
    elif fed.aggregation not in ("fedar", "fedavg"):
        raise ValueError(f"unknown aggregation {fed.aggregation!r}")
    if fed.compress != "none":
        later.append(f"compress={fed.compress!r}: Queue 1 item 9")
    if fed.faults != "none":
        later.append(f"faults={fed.faults!r}: Queue 1 item 10")
    if fed.mesh_shape is not None and fed.mesh_shape > 1:
        later.append(f"mesh_shape={fed.mesh_shape}: Queue 1 item 12")
    if fed.cohort_size is not None:
        later.append(f"cohort_size={fed.cohort_size}: Queue 1 item 11")
    if fed.select_frac is not None:
        later.append(f"select_frac={fed.select_frac}: Queue 1 item 8")
    if later:
        raise NotImplementedError(
            "not ported yet (see ROADMAP.md): " + "; ".join(later)
        )


class FedAREngine:
    """FedAR round engine over a simulated robot fleet.

    ``step`` runs one communication round, ``run`` R rounds.  ``draws`` is
    the draw provider (``convert.GeneratorDraws`` by default, seeded by
    ``FedConfig.seed``); ``init_params`` optionally replaces the model's
    own init (e.g. ``convert.params_from_jax`` of the reference's)."""

    def __init__(
        self,
        model: Union[ClientModel, MnistConfig],
        fed: FedConfig,
        req: TaskRequirement,
        *,
        lr: float = 0.1,
        device=None,
        draws=None,
        init_params=None,
    ):
        _check_slice(fed)
        if isinstance(model, MnistConfig):
            model = MnistClientModel(model)
        self.device = resolve_device(device)
        self.model = model
        self.fed, self.req, self.lr = fed, req, lr
        self.sgd_route = resolve_impl(fed.sgd_impl, "sgd", self.device)
        if self.sgd_route == "kernel" and not model.supports_fused:
            raise ValueError(
                f"sgd_impl={fed.sgd_impl!r} resolves to the fused kernel, but "
                f"model family {model.family!r} has none"
            )
        resolve_impl(fed.agg_impl, "agg", self.device)
        resolve_impl(fed.defense_impl, "defense", self.device)
        if init_params is None:
            gen = torch.Generator().manual_seed(fed.seed)
            self.template = model.init(gen, self.device)
        else:
            self.template = {k: torch.as_tensor(v, dtype=torch.float32,
                                                device=self.device)
                             for k, v in init_params.items()}
        self.dim = flatten(self.template).shape[0]
        self.defense = make_defense(fed, self.dim, self.device)
        self.resources0, self.poison_mask = make_fleet(
            fed.num_clients,
            num_starved=fed.num_starved,
            num_poisoners=fed.num_poisoners,
            seed=fed.seed,
            device=self.device,
        )
        self.draws = draws if draws is not None else GeneratorDraws(fed.seed, self.device)

    # ------------------------------------------------------------------
    def init_state(self) -> EngineState:
        N, D = self.fed.num_clients, self.dim
        return EngineState(
            params=flatten(self.template),
            trust=init_trust(N, self.fed, self.device),
            resources=self.resources0,
            fg_history=torch.zeros((N, self.defense.history_dim(D)),
                                   device=self.device),
            round_idx=0,
        )

    def device_data(self, data) -> dict:
        """The round's data dict as tensors on the engine's device, in the
        dtypes the kernels take (x float32, y / activations int32, sizes
        float32, mask bool); numpy arrays are copied over once."""
        for key, item in _LATER_DATA_KEYS.items():
            if key in data:
                raise NotImplementedError(
                    f'data[{key!r}] is not ported yet: ROADMAP.md {item}'
                )
        dtypes = {"x": torch.float32, "y": torch.int32,
                  "activations": torch.int32, "sizes": torch.float32,
                  "mask": torch.bool}
        out = {}
        for k, v in data.items():
            t = torch.as_tensor(v, device=self.device)
            out[k] = t.to(dtypes[k]).contiguous() if k in dtypes else t
        return out

    def _eval_set(self, eval_set):
        if eval_set is None:
            return None
        x, y = eval_set
        return (torch.as_tensor(x, dtype=torch.float32, device=self.device),
                torch.as_tensor(y, dtype=torch.int64, device=self.device))

    # ---------------------------------------------------- ClientUpdate
    def _block_sgd(self, g_flat, fields, m):
        """Local SGD over the client block -> stacked (rows, D) flat local
        params.  The kernel route launches the model's fused local-SGD
        kernel once for the whole block; the plain route runs the model's
        ``client_update`` (the dense path floors the batch count, R5 in
        ROADMAP.md)."""
        fed = self.fed
        if self.sgd_route == "kernel":
            return self.model.fused_block_update(
                g_flat, fields, m, lr=self.lr,
                batch_size=fed.local_batch_size, epochs=fed.local_epochs,
            )
        new = self.model.client_update(
            unflatten(g_flat, self.template), fields, lr=self.lr,
            batch_size=fed.local_batch_size, epochs=fed.local_epochs,
            sample_mask=m,
        )
        return flatten(new, rows=True)

    # ------------------------------------------------------------------
    def _round_step(self, state: EngineState, data, eval_set, force_straggler,
                    train_flops: float):
        """One communication round.  ``data``: the model's stacked
        per-client tensors (``x`` (N, n, 784), ``y`` (N, n), ``activations``
        (N,)), ``sizes`` (N,), and optionally ``mask`` (N, n) bool marking
        the real samples of ragged shards."""
        fed = self.fed
        N = fed.num_clients
        r = state.round_idx

        # --- Algorithm 2 lines 6-10: CheckResource + trust sort + sample
        selected, ok = select_clients(
            self.draws.gumbel(r, N), state.trust, state.resources, self.req, fed
        )

        # --- lines 16-21 (ClientUpdate) over the whole block;
        # non-participants are masked out of the aggregate
        g_flat = state.params
        fields = {k: data[k] for k in self.model.data_keys}
        locals_flat = self._block_sgd(g_flat, fields, data.get("mask"))
        deltas = locals_flat - g_flat[None, :]

        # --- virtual time: latency per client, straggler = late vs timeout
        lat = round_latency(
            state.resources, train_flops=train_flops,
            model_bytes=self.dim * 4.0, normal=self.draws.normal(r, N),
        )
        if force_straggler is not None:
            lat = torch.where(force_straggler, fed.timeout * 3.0, lat)
        on_time = lat <= fed.timeout
        # rows visible server-side: fedavg waits for stragglers, fedar skips
        seen = selected if fed.aggregation == "fedavg" else selected & on_time

        # --- non-finite quarantine (always on): a NaN/Inf row, or one past
        # the magnitude cap, contributes exact zeros and is branded deviated
        row_ok = torch.isfinite(deltas)
        cap = fed.resolved_quarantine_cap
        if cap is not None:
            row_ok = row_ok & (deltas.abs() <= cap)
        quarantined = ~row_ok.all(dim=-1)
        deltas = torch.where(quarantined[:, None], 0.0, deltas)

        # --- line 11: deviation ban + defense weights
        active = selected & on_time
        deviated = agg.deviation_mask(
            deltas, active & ~quarantined, fed.deviation_gamma
        )
        deviated = deviated | (seen & quarantined)
        contributing = active & ~deviated
        weights = data["sizes"]
        fg_history = self.defense.update_history(
            state.fg_history, deltas, contributing
        )
        fgw = self.defense.weights(fg_history, contributing)
        if fgw is not None:
            weights = weights * fgw

        # --- lines 13-14: aggregate
        if fed.aggregation == "fedavg":
            g_new = agg.fedavg_aggregate(
                g_flat, deltas, weights, selected & ~deviated, impl=fed.agg_impl
            )
            round_time = torch.where(selected, lat, 0.0).max()
        else:  # fedar (timeout skip)
            g_new = agg.fedavg_aggregate(
                g_flat, deltas, weights, contributing, impl=fed.agg_impl
            )
            round_time = torch.full((), fed.timeout, device=self.device)

        # --- line 15 + Algorithm 1: trust and battery evolution
        trust = update_trust(
            state.trust, fed, selected=selected, on_time=on_time,
            deviated=deviated, interested=ok,
        )
        resources = drain_battery(state.resources, selected)

        if eval_set is not None:
            loss, acc = self.model.metrics(unflatten(g_new, self.template), eval_set)
        else:
            loss = acc = torch.full((), torch.nan, device=self.device)

        new_state = EngineState(
            params=g_new, trust=trust, resources=resources,
            fg_history=fg_history, round_idx=r + 1,
        )
        outputs = RoundOutputs(
            trust=trust.score, selected=selected, on_time=on_time,
            round_time=round_time, loss=loss, acc=acc,
        )
        return new_state, outputs

    # ------------------------------------------------------------------
    def _train_flops(self, data) -> float:
        shape = tuple(data[self.model.data_keys[0]].shape[1:])
        return float(self.model.train_flops(shape, epochs=self.fed.local_epochs))

    def _force(self, force_straggler):
        if force_straggler is None:
            return None
        return torch.as_tensor(force_straggler, dtype=torch.bool, device=self.device)

    def step(self, state, data, *, eval_set=None, force_straggler=None):
        """One communication round -> (state, RoundOutputs)."""
        data = self.device_data(data)
        with torch.no_grad():
            return self._round_step(
                state, data, self._eval_set(eval_set),
                self._force(force_straggler), self._train_flops(data),
            )

    def run(self, state, data, *, rounds: int, eval_set=None,
            force_straggler=None):
        """``rounds`` rounds -> (state, outputs stacked over rounds)."""
        data = self.device_data(data)
        eval_set = self._eval_set(eval_set)
        force = self._force(force_straggler)
        flops = self._train_flops(data)
        outs = []
        with torch.no_grad():
            for _ in range(rounds):
                state, out = self._round_step(state, data, eval_set, force, flops)
                outs.append(out)
        return state, RoundOutputs(*(torch.stack(f) for f in zip(*outs)))
