"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed experts top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B].  24L d_model=2048 16H(kv=16) d_ff=1408
vocab=151936."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    num_experts=60,
    num_experts_per_tok=4,
    num_shared_experts=4,
    moe_d_ff=1408,
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
