"""deepseek-coder-33b [dense] — llama-arch GQA [arXiv:2401.14196].

62L d_model=7168 56H (kv=8) d_ff=19200 vocab=32256.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense", num_layers=62, d_model=7168,
    num_heads=56, num_kv_heads=8, head_dim=128, d_ff=19200,
    vocab_size=32256,
)

SMOKE = ModelConfig(
    name="deepseek-coder-smoke", family="dense", num_layers=3, d_model=64,
    num_heads=8, num_kv_heads=2, head_dim=8, d_ff=160, vocab_size=256,
    remat=False,
)
