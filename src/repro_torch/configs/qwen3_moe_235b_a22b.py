"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, GQA kv=4.

94L d_model=4096 64H d_ff(expert)=1536 vocab=151936
[hf:Qwen/Qwen3-30B-A3B scaled per assignment].
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", num_layers=94, d_model=4096,
    num_heads=64, num_kv_heads=4, head_dim=128, d_ff=1536,
    vocab_size=151936,
    num_experts=128, experts_per_token=8, moe_d_ff=1536,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe", num_layers=3, d_model=64,
    num_heads=8, num_kv_heads=2, head_dim=8, d_ff=96, vocab_size=256,
    num_experts=8, experts_per_token=2, moe_d_ff=48, remat=False,
)
