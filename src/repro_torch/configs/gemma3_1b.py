"""gemma3-1b [dense]: 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt].  26L d_model=1152 4H(kv=1) d_ff=6912
vocab=262144, head_dim=256, local window 512."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    global_every=6,
    local_window=512,
    tie_embeddings=True,
    act="gelu",
    citation="hf:google/gemma-3-1b-pt",
)
