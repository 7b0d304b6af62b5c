"""zamba2-7b [hybrid]: Mamba2 backbone + one shared attention block
[arXiv:2411.15242].  81L d_model=3584 32H(kv=32) d_ff=14336 vocab=32000
ssm_state=64."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    shared_attn_every=6,
    citation="arXiv:2411.15242",
)
