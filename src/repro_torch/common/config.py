"""Configuration dataclasses: the LM architecture (``ModelConfig``), the
workload shapes (``InputShape``, ``INPUT_SHAPES``), the FedAR
hyper-parameters (``FedConfig``, Table I trust constants et al.), the
trainer's (``TrainConfig``) and the production mesh (``MeshConfig``).

The port's own copies of the reference's dataclasses: the same field names
and defaults, so a config written for one package reads the same in the
other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description.

    Families:
      dense   -- transformer w/ GQA, MLA or local/global attention
      moe     -- transformer w/ mixture-of-experts FFN (routed + shared)
      ssm     -- state-space / recurrent blocks (mamba2, slstm, mlstm)
      hybrid  -- ssm blocks + (shared) attention blocks interleaved
      vlm     -- dense decoder consuming stubbed patch embeddings + text
      audio   -- dense decoder over codec tokens (frontend stubbed)
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // num_heads

    # --- attention variant ---
    attention: str = "gqa"  # gqa | mla | none
    sliding_window: int = 0  # 0 = full attention
    # gemma3-style pattern: every `global_every`-th layer is global, rest local
    global_every: int = 0  # 0 = uniform
    local_window: int = 0  # window for local layers when global_every > 0
    rope_theta: float = 10000.0

    # --- MLA (minicpm3 / deepseek-style) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden; 0 -> d_ff
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    router_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25  # tokens-per-expert headroom; large=dropless
    # dispatch implementation: "onehot" (GShard dense einsum) | "scatter"
    # (indexed scatter/gather — no dispatch matmul FLOPs; see §Perf)
    moe_dispatch: str = "onehot"

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128

    # --- hybrid / block pattern ---
    # "m"*k means mamba2, "a" attention, "s" slstm, "x" mlstm.  For zamba2 we
    # use shared_attn_every: one weight-shared attention block applied after
    # every k-th ssm layer.
    block_pattern: str = ""
    shared_attn_every: int = 0

    # --- modality frontends (stubbed per brief) ---
    frontend: str = ""  # "" | vision_stub | audio_stub
    num_patches: int = 0  # vlm: patch embeddings per image

    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"  # silu | gelu
    dtype: str = "bfloat16"
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.num_heads

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def reduced(self, **over) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests (<=2 layers,
        d_model<=512, <=4 experts)."""
        kw = dict(
            num_layers=min(self.num_layers, 2),
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=64 if self.head_dim else None,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            local_window=min(self.local_window, 32) if self.local_window else 0,
            q_lora_rank=min(self.q_lora_rank, 64) if self.q_lora_rank else 0,
            kv_lora_rank=min(self.kv_lora_rank, 32) if self.kv_lora_rank else 0,
            qk_nope_dim=min(self.qk_nope_dim, 32) if self.qk_nope_dim else 0,
            qk_rope_dim=min(self.qk_rope_dim, 16) if self.qk_rope_dim else 0,
            v_head_dim=min(self.v_head_dim, 32) if self.v_head_dim else 0,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2)
            if self.num_experts_per_tok
            else 0,
            num_shared_experts=min(self.num_shared_experts, 1)
            if self.num_shared_experts
            else 0,
            moe_d_ff=min(self.resolved_moe_d_ff, 256) if self.num_experts else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 32),
            ssm_chunk=16 if self.ssm_state else self.ssm_chunk,
            shared_attn_every=min(self.shared_attn_every, 2)
            if self.shared_attn_every
            else 0,
            num_patches=min(self.num_patches, 16) if self.num_patches else 0,
            dtype="float32",
        )
        kw.update(over)
        return dataclasses.replace(self, **kw)



@dataclass(frozen=True)
class InputShape:
    """One of the assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


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


@dataclass(frozen=True)
class TrainConfig:
    """The trainer's optimizer, schedule and step options
    (``launch/train.py``, ``optim/``)."""

    optimizer: str = "sgd"  # sgd | momentum | adamw
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 0.0
    warmup_steps: int = 0
    schedule: str = "const"  # const | cosine
    total_steps: int = 1000
    remat: bool = True
    loss_chunk: int = 0  # 0 = unchunked; else vocab-loss computed seq-chunked
    # Kept for parity with the reference, where it unrolls the layer scan
    # (its roofline cost-analysis mode).  It changes nothing here: the
    # port's layers are always a Python loop.
    unroll: bool = False


@dataclass(frozen=True)
class MeshConfig:
    data: int = 16
    model: int = 16
    pods: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.pods
