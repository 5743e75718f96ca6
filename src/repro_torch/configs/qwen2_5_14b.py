"""qwen2.5-14b [dense] — GQA kv=8, QKV bias [hf:Qwen/Qwen2.5 family].

48L d_model=5120 40H d_ff=13824 vocab=152064.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense", num_layers=48, d_model=5120,
    num_heads=40, num_kv_heads=8, head_dim=128, d_ff=13824,
    vocab_size=152064, qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke", family="dense", num_layers=3, d_model=64,
    num_heads=8, num_kv_heads=2, head_dim=8, d_ff=160, vocab_size=256,
    qkv_bias=True, remat=False,
)
