"""internvl2-1b [vlm]: InternViT (stubbed frontend) + InternLM2 decoder
[arXiv:2404.16821].  24L d_model=896 14H(kv=2) d_ff=4864 vocab=151655."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    frontend="vision_stub",
    num_patches=256,
    citation="arXiv:2404.16821",
)
