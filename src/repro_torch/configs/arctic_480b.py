"""arctic-480b [moe]: 128 experts top-2 with a parallel dense residual FFN
[hf:Snowflake/snowflake-arctic-base].  35L d_model=7168 56H(kv=8) d_ff=4864
vocab=32000."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    num_experts_per_tok=2,
    moe_d_ff=4864,
    dense_residual=True,
    citation="hf:Snowflake/snowflake-arctic-base",
)
