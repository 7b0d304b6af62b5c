"""FedAR hyper-parameters (Table I trust constants et al.).

The port's own copy of the reference ``FedConfig``: the same field names
and defaults, so a config written for one package reads the same in the
other.  Fields whose feature a later slice ports are kept here and
rejected by the engine with ``NotImplementedError`` when switched on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class FedConfig:
    """FedAR hyper-parameters.  Trust constants are Table I of the paper."""

    num_clients: int = 12
    # fleet heterogeneity: None -> scale the paper's 2-of-12 profile with the
    # fleet (see resources.make_fleet); int -> exact count
    num_starved: Optional[int] = None
    num_poisoners: Optional[int] = None
    client_fraction: float = 0.5  # F in Algorithm 2
    local_epochs: int = 5  # E
    local_batch_size: int = 20  # B (paper simulation setting)
    timeout: float = 10.0  # t, virtual seconds
    deviation_gamma: float = 3.0  # gamma: ban if ||G - D_m|| > gamma * sigma
    # Table I
    c_initial: float = 50.0
    c_reward: float = 8.0
    c_interested: float = 1.0
    c_penalty: float = -2.0
    c_blame: float = -8.0
    c_ban: float = -16.0
    # failure-rate bands of Algorithm 1
    penalty_band: float = 0.2  # failure rate < 0.2 -> penalty
    blame_band: float = 0.5  # [0.2, 0.5) -> blame; >= 0.5 -> ban
    min_trust: float = 0.0  # clients below this are ineligible
    # fedavg (waits for stragglers) | fedar (timeout skip) | async | async_seq
    aggregation: str = "fedar"
    # kernel routing, auto | kernel | einsum (see kernels/ops.resolve_impl)
    agg_impl: str = "auto"
    sgd_impl: str = "auto"
    # selection-gated local SGD cohort cap (fraction of the fleet)
    select_frac: Optional[float] = None
    # "trust" (FedAR, Alg 2 line 8) | "random" (the baseline)
    selection: str = "trust"
    # host-store cohort mode: K clients per round from a host client table
    cohort_size: Optional[int] = None
    tree_reduce: bool = False
    staleness_alpha: float = 0.6  # FedAsync mixing weight
    staleness_decay: str = "poly"  # poly | const
    # legacy on/off switch; still honored when ``defense`` is unset
    foolsgold: bool = True
    # None -> legacy mapping; "none" | "foolsgold" | "foolsgold_sketch"
    defense: Optional[str] = None
    defense_sketch_dim: int = 256  # count-sketch width r
    defense_history_decay: float = 1.0  # per-round history decay
    defense_impl: str = "auto"
    # uplink compression: none | qsgd | topk
    compress: str = "none"
    compress_bits: int = 8
    compress_k: Optional[int] = None
    compress_impl: str = "auto"
    # fault injection: none | crash | corrupt | battery | flaky | chaos
    faults: str = "none"
    fault_crash_rate: float = 0.1
    fault_corrupt_frac: float = 0.25
    fault_corrupt_rate: float = 0.5
    fault_battery_frac: float = 0.25
    fault_battery_rounds: int = 8
    fault_flap_frac: float = 0.25
    fault_flap_period: int = 8
    fault_flap_rounds: int = 3
    # non-finite quarantine magnitude cap (None -> isfinite-only when
    # faults are off, 1e6 under a fault schedule)
    quarantine_cap: Optional[float] = None
    # cluster-aware defense: m_i = 1 + sum_j relu(cs_ij)^power, full weight
    # while m_i <= slack * median(m), then (slack*median/m)^sharpness
    defense_cluster_power: float = 8.0
    defense_cluster_slack: float = 5.0
    defense_cluster_sharpness: float = 3.0
    # devices along the client axis (None or 1 = one device)
    mesh_shape: Optional[int] = None
    client_axis: str = "clients"
    seed: int = 0

    @property
    def resolved_defense(self) -> str:
        """Active defense strategy name (``defense`` wins over the legacy
        ``foolsgold`` boolean)."""
        if self.defense is not None:
            return self.defense
        return "foolsgold" if self.foolsgold else "none"

    @property
    def resolved_quarantine_cap(self) -> Optional[float]:
        """Magnitude cap for the non-finite quarantine row guard: an
        explicit ``quarantine_cap`` wins, else 1e6 under an active fault
        schedule, else ``None`` (isfinite-only)."""
        if self.quarantine_cap is not None:
            return self.quarantine_cap
        return 1e6 if self.faults != "none" else None
