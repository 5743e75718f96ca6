"""Shared model building blocks: the config, norms, RoPE, the loss and
the initializer — twin of ``repro.models.common``.

The reference's sharding helpers have no object on one card: the
logical-axis rules (:func:`mesh_rules`) stay as plain data and
:func:`constrain` is the identity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config object covers all 10 assigned architectures."""
    name: str = "model"
    family: str = "dense"  # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 32
    d_ff: int = 256
    vocab_size: int = 1000
    act: str = "silu"            # silu (SwiGLU) | gelu (GeGLU)
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rmsnorm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False   # gemma-style sqrt(d) embedding multiplier
    # --- MoE (deepseek-v3 / qwen3-moe) ---
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    moe_group: int = 512
    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- multi-token prediction (deepseek-v3) ---
    mtp_depth: int = 0
    # --- hybrid / ssm ---
    block_pattern: Tuple[str, ...] = ()   # per-layer: "attn"|"rglru"|"ssd"
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    conv_width: int = 4
    window: int = 0                        # local-attention window
    lru_width: int = 0
    # --- encoder-decoder (seamless) ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    # --- multimodal stub frontend ---
    frontend: str = "none"                 # none | patches | frames
    num_patches: int = 0
    # --- numerics / scale ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True          # torch.utils.checkpoint over each unit
    plan_override: tuple = ()
    scan_layers: bool = True    # no effect here: the stacks always loop
    q_chunk: int = 1024         # blockwise-attention block sizes
    kv_chunk: int = 1024
    shard_cache_seq: bool = False

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def pattern(self) -> Tuple[str, ...]:
        if self.block_pattern:
            assert len(self.block_pattern) == self.num_layers
            return self.block_pattern
        return ("attn",) * self.num_layers


# ---------------- sharding helpers ----------------
# Logical axes as the reference names them; on one card nothing is
# sharded, so they are data only.

def mesh_rules(multi_pod: bool):
    dp = ("pod", "data") if multi_pod else ("data",)
    return {"dp": dp, "fsdp": dp, "tp": "model", "sp": "model"}


def constrain(x, spec_names, rules):
    """The reference's sharding constraint: the identity on one card."""
    return x


# ---------------- numerics ----------------

def rms_norm(x, scale, eps):
    var = x.float().square().mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps).to(x.dtype) * (1.0 + scale.to(x.dtype))


def make_rope(positions, dim: int, theta: float, dtype):
    """positions [*, S] -> (sin, cos) each [*, S, dim/2]; the angles in
    fp32 before the cast."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / torch.pow(float(theta), exps)
    angles = positions[..., None].float() * freqs
    return torch.sin(angles).to(dtype), torch.cos(angles).to(dtype)


def apply_rope(x, sin, cos):
    """x [..., S, H, D]; sin/cos [..., S, D/2] broadcast over heads."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    s = sin[..., None, :]
    c = cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def const(value: float, like: torch.Tensor) -> float:
    """``value`` rounded to ``like``'s dtype, as a Python float: a
    multiply by it rounds as one by a constant of that dtype does, and
    no tensor is copied to the device."""
    return torch.tensor(value, dtype=like.dtype).item()


def silu(x):
    """``jax.nn.silu`` as XLA evaluates it: ``x * 1 / (1 + exp(-x))``,
    one rounding to x's dtype after each operation (so bf16 matches the
    reference's bf16, which ``F.silu``'s single rounding does not)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x):
    """``jax.nn.gelu``'s default tanh approximation, operation by
    operation as XLA evaluates it, its constants in x's dtype."""
    inner = const(math.sqrt(2 / math.pi), x) * (
        x + const(0.044715, x) * (x * x * x))
    return x * (const(0.5, x) * (1 + torch.tanh(inner)))


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def act_fn(name: str):
    return {"silu": silu, "gelu": gelu}[name]


def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def truncated_normal(gen: torch.Generator, shape, dtype, scale):
    """A normal draw cut to [-2, 2], times ``scale``, in ``dtype``, on
    the generator's device."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale).to(dtype)       # in place: one fp32 copy at peak


def generator(seed: int, device) -> torch.Generator:
    """A torch generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))
