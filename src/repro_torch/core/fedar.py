"""FedAR end-to-end simulation: Algorithm 2 as a server object.

Simulates the robot fleet of §IV (heterogeneous resources, stragglers,
poisoners, trust evolution) through :class:`repro_torch.core.engine
.FedAREngine`, or, with ``FedConfig.cohort_size`` below the fleet size,
through the host-store :class:`repro_torch.core.engine.CohortEngine`.
``FedARServer`` keeps the reference's public API (``run_round`` / ``run``
and a ``history`` dict of per-round rows) and runs on the card unless
``device="cpu"`` is passed.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np

from repro_torch.common.config import FedConfig
from repro_torch.core.engine import (
    CohortEngine,
    FedAREngine,
    RoundOutputs,
    unflatten,
)
from repro_torch.core.resources import TaskRequirement
from repro_torch.data.datasets import FederatedDataset


@dataclass
class FedARServer:
    """Holds server-side state and runs communication rounds.

    ``cfg`` is an ``MnistConfig`` (the paper's MLP client) or any
    ``ClientModel``; ``device`` ``None`` means the card; ``draws`` and
    ``init_params`` pass through to the engine."""

    cfg: Any
    fed: FedConfig
    req: TaskRequirement
    lr: float = 0.1
    device: Any = None
    draws: Any = None
    init_params: Any = None

    def __post_init__(self):
        # cohort_size >= N: the "cohort" is the whole fleet, the resident
        # engine exactly
        if (self.fed.cohort_size is not None
                and self.fed.cohort_size >= self.fed.num_clients):
            self.fed = dataclasses.replace(self.fed, cohort_size=None)
        self.cohort_mode = self.fed.cohort_size is not None
        engine = CohortEngine if self.cohort_mode else FedAREngine
        self.engine = engine(
            self.cfg, self.fed, self.req, lr=self.lr, device=self.device,
            draws=self.draws, init_params=self.init_params,
        )
        # in cohort mode the server state lives in engine.store / params
        self.state = None if self.cohort_mode else self.engine.init_state()
        self.template = self.engine.template
        self.dim = self.engine.dim
        self.poison_mask = self.engine.poison_mask
        self.history: Dict[str, List[Any]] = {
            "trust": [], "selected": [], "on_time": [], "loss": [], "acc": [],
            "round_time": [],
        }
        if self.cohort_mode:
            # per-round (K,) client indices and slot validity; the trust /
            # selected / on_time rows are cohort-indexed in this mode (row j
            # belongs to fleet client cohort[r][0][j])
            self.history["cohort"] = []

    @property
    def params(self):
        flat = self.engine.params if self.cohort_mode else self.state.params
        return unflatten(flat, self.template)

    @property
    def trust(self):
        if self.cohort_mode:
            return self.engine.store.trust_view()
        return self.state.trust

    @property
    def resources(self):
        if self.cohort_mode:
            return self.engine.store.resources_view()
        return self.state.resources

    @property
    def fg_history(self):
        if self.cohort_mode:
            return self.engine.store.history
        return self.state.fg_history

    @property
    def round_idx(self) -> int:
        if self.cohort_mode:
            return self.engine.round_idx
        return self.state.round_idx

    def _append(self, out: RoundOutputs, rounds: int, with_eval: bool):
        """Fold stacked (or single-round) outputs into the history dict
        (one device-to-host copy per field)."""
        trust = np.atleast_2d(out.trust.cpu().numpy())
        selected = np.atleast_2d(out.selected.cpu().numpy())
        on_time = np.atleast_2d(out.on_time.cpu().numpy())
        round_time = out.round_time.cpu().numpy().reshape(rounds)
        loss = out.loss.cpu().numpy().reshape(rounds)
        acc = out.acc.cpu().numpy().reshape(rounds)
        for r in range(rounds):
            self.history["trust"].append(trust[r])
            self.history["selected"].append(selected[r])
            self.history["on_time"].append(on_time[r])
            self.history["round_time"].append(float(round_time[r]))
            if with_eval:
                self.history["loss"].append(float(loss[r]))
                self.history["acc"].append(float(acc[r]))

    def _resident_data(self, data):
        """A fleet object passed instead of a data dict is prepared here
        (``FedAREngine.prepare_data``: dense or packed, per fleet); a
        ``VirtualFleet`` is materialized first, so the same fleet can go to
        a cohort server and a resident one."""
        if hasattr(data, "materialize"):
            data = data.materialize()
        if isinstance(data, FederatedDataset):
            return self.engine.prepare_data(data)
        return data

    def run_round(self, data, *, eval_set=None, force_straggler=None):
        """One communication round.  ``data``: dict of stacked per-client
        arrays x (N, n, 784), y (N, n), sizes (N,), activations (N,)
        (0=relu, 1=softmax, Table II), optionally mask (N, n) and
        round_mask (W, N, n); or a packed dict (``data["packed"]``); or a
        fleet object (``FederatedDataset``, ``VirtualFleet``), which cohort
        mode requires."""
        if self.cohort_mode:
            if force_straggler is not None:
                raise ValueError(
                    "force_straggler is a resident-engine test hook; the "
                    "cohort engine has no stable client axis to force"
                )
            idx, valid, out = self.engine.run_round(data, eval_set=eval_set)
            self._append(out, 1, eval_set is not None)
            self.history["cohort"].append((idx, valid))
            return out.selected.cpu().numpy(), out.on_time.cpu().numpy()
        data = self._resident_data(data)
        self.state, out = self.engine.step(
            self.state, data, eval_set=eval_set, force_straggler=force_straggler
        )
        self._append(out, 1, eval_set is not None)
        return out.selected.cpu().numpy(), out.on_time.cpu().numpy()

    def run(self, data, rounds: int, eval_set=None, force_straggler=None,
            driver: str = "scan"):
        """Run ``rounds`` communication rounds; returns ``history``.  Cohort
        mode samples a fresh cohort from the store each round.

        ``driver`` keeps the reference's two values: there, ``"scan"`` runs
        the rounds inside one ``lax.scan`` and ``"python"`` dispatches them
        one by one.  The port has one host loop over rounds, which both
        name; any other value raises ``ValueError``."""
        if driver not in ("scan", "python"):
            raise ValueError(f'unknown driver {driver!r} (expected "scan" or "python")')
        if self.cohort_mode:
            for _ in range(rounds):
                self.run_round(data, eval_set=eval_set,
                               force_straggler=force_straggler)
            return self.history
        data = self._resident_data(data)
        self.state, outs = self.engine.run(
            self.state, data, rounds=rounds, eval_set=eval_set,
            force_straggler=force_straggler,
        )
        self._append(outs, rounds, eval_set is not None)
        return self.history
