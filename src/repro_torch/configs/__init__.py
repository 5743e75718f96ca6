"""Config registry: --arch <id> -> (full CONFIG, reduced SMOKE)."""
from __future__ import annotations

import importlib

from repro_torch.configs.shapes import SHAPES, ShapeCell, applicable, cells_for

_MODULES = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "gemma-7b": "gemma_7b",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen2-72b": "qwen2_72b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mamba2-370m": "mamba2_370m",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def param_count(cfg) -> int:
    """Analytic parameter count (matches init; used for roofline
    MODEL_FLOPS without materializing weights)."""
    d, v = cfg.d_model, cfg.vocab_size
    total = v * d  # embed
    if not cfg.tie_embeddings:
        total += d * v
    from repro_torch.models.transformer import layer_specs
    if cfg.is_encoder_decoder:
        attn = d * cfg.num_heads * cfg.head_dim * 2 + \
            d * cfg.num_kv_heads * cfg.head_dim * 2
        ffn = 3 * d * cfg.d_ff
        total += cfg.encoder_layers * (attn + ffn)
        total += cfg.num_layers * (2 * attn + ffn)  # self + cross
        return total
    for (mixer, ffn_kind, _w) in layer_specs(cfg):
        if mixer == "attn":
            total += d * cfg.num_heads * cfg.head_dim * 2
            total += d * cfg.num_kv_heads * cfg.head_dim * 2
        elif mixer == "mla":
            nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
            total += d * cfg.q_lora_rank
            total += cfg.q_lora_rank * cfg.num_heads * (nd + rd)
            total += d * (cfg.kv_lora_rank + rd)
            total += cfg.kv_lora_rank * cfg.num_heads * (nd + vd)
            total += cfg.num_heads * vd * d
        elif mixer == "rglru":
            w = cfg.lru_width or d
            total += 2 * d * w + 2 * w * w + w * d
        elif mixer == "ssd":
            di = 2 * d
            n = cfg.ssm_state_dim
            h = di // cfg.ssm_head_dim
            total += d * (2 * di + 2 * n + h) + di * d
        if ffn_kind == "dense":
            total += 3 * d * cfg.d_ff
        elif ffn_kind == "moe":
            total += d * cfg.num_experts
            total += cfg.num_experts * 3 * d * cfg.moe_d_ff
            total += cfg.num_shared_experts * 3 * d * cfg.moe_d_ff
    return total


def active_param_count(cfg) -> int:
    """Active params per token (MoE: only routed top-k experts)."""
    if not cfg.num_experts:
        return param_count(cfg)
    total = param_count(cfg)
    from repro_torch.models.transformer import layer_specs
    moe_layers = sum(1 for s in layer_specs(cfg) if s[1] == "moe")
    all_experts = moe_layers * cfg.num_experts * 3 * cfg.d_model * \
        cfg.moe_d_ff
    active = moe_layers * cfg.experts_per_token * 3 * cfg.d_model * \
        cfg.moe_d_ff
    return total - all_experts + active
