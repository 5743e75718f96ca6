"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, pattern
(rec, rec, attn) [arXiv:2402.19427].

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, window=2048,
lru_width=2560.  Sub-quadratic -> runs long_500k.
"""
from repro_torch.models.common import ModelConfig

_PATTERN = tuple(
    "attn" if i % 3 == 2 else "rglru" for i in range(26))

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", num_layers=26,
    d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256, d_ff=7680,
    vocab_size=256000, act="gelu", embed_scale=True, tie_embeddings=True,
    block_pattern=_PATTERN, window=2048, lru_width=2560, conv_width=4,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid", num_layers=5,
    d_model=64, num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128,
    vocab_size=256, act="gelu", embed_scale=True, tie_embeddings=True,
    block_pattern=tuple("attn" if i % 3 == 2 else "rglru"
                        for i in range(5)),
    window=8, lru_width=64, conv_width=4, remat=False,
)
