"""llava-next-mistral-7b [vlm] — anyres tiling; vision frontend is a
STUB: input_specs provides precomputed patch embeddings
[B, num_patches, d_model] [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Backbone = Mistral-7B: 32L d_model=4096 32H (kv=8) d_ff=14336
vocab=32000.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm", num_layers=32,
    d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
    vocab_size=32000, frontend="patches", num_patches=2880,
)

SMOKE = ModelConfig(
    name="llava-smoke", family="vlm", num_layers=3, d_model=64,
    num_heads=8, num_kv_heads=2, head_dim=8, d_ff=160, vocab_size=256,
    frontend="patches", num_patches=16, remat=False,
)
