"""musicgen-medium [audio]: decoder-only LM over EnCodec tokens
[arXiv:2306.05284].  48L d_model=1536 24H(kv=24) d_ff=6144 vocab=2048.
The EnCodec tokenizer/conv codec is the stubbed frontend (brief carve-out);
inputs are codec token ids."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    frontend="audio_stub",
    act="gelu",
    citation="arXiv:2306.05284",
)
