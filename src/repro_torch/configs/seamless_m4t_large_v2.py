"""seamless-m4t-large-v2 [audio] — enc-dec transformer backbone
[arXiv:2308.11596].  Modality frontend is a STUB: input_specs provides
precomputed frame embeddings [B, S, d_model].

24L (enc) + 24L (dec) d_model=1024 16H d_ff=8192 vocab=256206.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec", num_layers=24,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64, d_ff=8192,
    vocab_size=256206, is_encoder_decoder=True, encoder_layers=24,
    frontend="frames",
)

SMOKE = ModelConfig(
    name="seamless-smoke", family="encdec", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
    is_encoder_decoder=True, encoder_layers=2, frontend="frames",
    remat=False,
)
