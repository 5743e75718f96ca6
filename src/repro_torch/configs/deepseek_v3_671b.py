"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed top-8 + MTP.

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280 [arXiv:2412.19437].
Dense d_ff=18432 on the first 3 layers (paper); MLA ranks q=1536,
kv=512, nope/rope head dims 128/64, v_head 128.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe", num_layers=61, d_model=7168,
    num_heads=128, num_kv_heads=128, head_dim=128, d_ff=18432,
    vocab_size=129280,
    num_experts=256, num_shared_experts=1, experts_per_token=8,
    moe_d_ff=2048, first_dense_layers=3,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
    qk_rope_dim=64, v_head_dim=128,
    mtp_depth=1,
    block_pattern=("mla",) * 61,
)

SMOKE = ModelConfig(
    name="deepseek-v3-smoke", family="moe", num_layers=4, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
    num_experts=8, num_shared_experts=1, experts_per_token=2, moe_d_ff=32,
    first_dense_layers=1,
    use_mla=True, q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
    qk_rope_dim=8, v_head_dim=16,
    mtp_depth=1, block_pattern=("mla",) * 4, remat=False,
)
