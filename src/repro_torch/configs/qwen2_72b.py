"""qwen2-72b [dense] — GQA kv=8, QKV bias [arXiv:2407.10671].

80L d_model=8192 64H d_ff=29568 vocab=152064.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=29568,
    vocab_size=152064, qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen2-72b-smoke", family="dense", num_layers=3, d_model=64,
    num_heads=8, num_kv_heads=2, head_dim=8, d_ff=192, vocab_size=256,
    qkv_bias=True, remat=False,
)
