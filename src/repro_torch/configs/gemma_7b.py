"""gemma-7b [dense] — GeGLU, head_dim=256, MHA (kv=16), tied embeddings
[arXiv:2403.08295].

28L d_model=3072 16H d_ff=24576 vocab=256000.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense", num_layers=28, d_model=3072,
    num_heads=16, num_kv_heads=16, head_dim=256, d_ff=24576,
    vocab_size=256000, act="gelu", tie_embeddings=True, embed_scale=True,
)

SMOKE = ModelConfig(
    name="gemma-smoke", family="dense", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=32, d_ff=192, vocab_size=256,
    act="gelu", tie_embeddings=True, embed_scale=True, remat=False,
)
