"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1024 attn-free (d_ff=0, mixer-only blocks) vocab=50280,
ssm_state=128, head_dim=64, expand=2.  Sub-quadratic -> runs long_500k.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm", num_layers=48, d_model=1024,
    num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=50280,
    ssm_state_dim=128, ssm_head_dim=64, ssm_chunk=64, conv_width=4,
    tie_embeddings=True, block_pattern=("ssd",) * 48,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm", num_layers=3, d_model=64,
    num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=256,
    ssm_state_dim=16, ssm_head_dim=16, ssm_chunk=8, conv_width=4,
    tie_embeddings=True, block_pattern=("ssd",) * 3, remat=False,
)
