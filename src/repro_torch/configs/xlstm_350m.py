"""xlstm-350m [ssm]: alternating sLSTM + mLSTM blocks [arXiv:2405.04517].
24L d_model=1024 4H d_ff=0 vocab=50304."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    attention="none",
    block_pattern="sx" * 12,
    citation="arXiv:2405.04517",
)
