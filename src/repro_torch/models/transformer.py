"""Decoder-only transformer stack for all assigned LM architectures —
twin of ``repro.models.transformer``.

Layer mixers dispatch on the config pattern: "attn" (GQA), "mla"
(DeepSeek), "rglru" (RecurrentGemma), "ssd" (Mamba-2); the FFN is dense,
MoE or absent per layer.  Consecutive identical layers form a *stack*
whose parameters carry a leading [count] axis, as the reference's
scanned stacks do (``count == 1`` included), so the two packages'
parameter trees have the same paths and shapes; hybrid patterns
(RecurrentGemma's rec-rec-attn) stack as a repeating unit.  A stack runs
as a Python loop over its units; with ``cfg.remat`` and gradients on,
each unit runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of the scan body).  The multi-token-prediction head's
layer is not stacked: its leaves have no [count] axis.

Public entry points (used by ``models.model``):
  init_model(gen, cfg)       -> (params, specs)
  forward(params, cfg, rules, tokens/embeds, positions, caches, ...)
  mtp_logits(params, cfg, rules, hidden, next_tokens, positions)
  init_caches(cfg, batch, max_len, dtype, device)
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (ModelConfig, const, constrain,
                                       rms_norm, truncated_normal)
from repro_torch.tree import tree_leaves, tree_map, tree_stack

LayerSpec = Tuple[str, str, int]  # (mixer, ffn_kind, window)


# ----------------------------- plan ---------------------------------

def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    out = []
    for i, mixer in enumerate(cfg.pattern()):
        if cfg.num_experts and i >= cfg.first_dense_layers:
            ffn_kind = "moe"
        elif cfg.d_ff == 0:
            ffn_kind = "none"   # mamba2: mixer-only blocks
        else:
            ffn_kind = "dense"
        window = cfg.window if (mixer == "attn" and cfg.window) else 0
        out.append((mixer, ffn_kind, window))
    return out


def build_plan(cfg: ModelConfig) -> List[Tuple[Tuple[LayerSpec, ...], int]]:
    """Compress per-layer specs into [(unit, count)] stacks."""
    if cfg.plan_override:
        return [(tuple(tuple(s) for s in unit), count)
                for unit, count in cfg.plan_override]
    specs = layer_specs(cfg)
    n = len(specs)
    # try a short repeating period (hybrid patterns)
    for p in range(1, 9):
        if all(specs[i] == specs[i % p] for i in range(n)) and n // p >= 2:
            unit = tuple(specs[:p])
            full = n // p
            plan = [(unit, full)]
            if n % p:
                plan.append((tuple(specs[full * p:]), 1))
            return plan
    # fall back to maximal runs of identical layers
    plan = []
    i = 0
    while i < n:
        j = i
        while j < n and specs[j] == specs[i]:
            j += 1
        plan.append(((specs[i],), j - i))
        i = j
    return plan


# --------------------------- init -----------------------------------

def _init_layer(gen, cfg: ModelConfig, spec: LayerSpec):
    mixer, ffn_kind, _ = spec
    if mixer == "attn":
        mp, ms = attn_lib.init_gqa(gen, cfg)
    elif mixer == "mla":
        mp, ms = attn_lib.init_mla(gen, cfg)
    elif mixer == "rglru":
        mp, ms = rglru_lib.init_rglru(gen, cfg)
    elif mixer == "ssd":
        mp, ms = ssm_lib.init_ssd(gen, cfg)
    else:
        raise ValueError(mixer)
    if ffn_kind == "moe":
        fp, fs = moe_lib.init_moe(gen, cfg)
    elif ffn_kind == "none":
        fp, fs = {}, {}
    else:
        fp, fs = ffn_lib.init_ffn(gen, cfg)
    zeros = dict(dtype=cfg.pdtype, device=gen.device)
    params = {"mixer": mp, "ffn": fp,
              "ln1": torch.zeros((cfg.d_model,), **zeros),
              "ln2": torch.zeros((cfg.d_model,), **zeros)}
    specs = {"mixer": ms, "ffn": fs, "ln1": (None,), "ln2": (None,)}
    return params, specs


def _stack_init(gen, cfg: ModelConfig, unit, count: int):
    """Init ``count`` copies of ``unit`` into leaves with a leading
    [count] axis, filled one copy at a time."""
    def unit_init():
        ps, ss = {}, {}
        for j, spec in enumerate(unit):
            ps[f"slot{j}"], ss[f"slot{j}"] = _init_layer(gen, cfg, spec)
        return ps, ss

    p0, s0 = unit_init()
    stacked = tree_map(lambda a: a.new_empty((count, *a.shape)), p0)

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i] = v
    fill(stacked, p0, 0)
    for i in range(1, count):
        fill(stacked, unit_init()[0], i)
    specs = _map_specs(lambda sp: (None, *sp), s0)
    return stacked, specs


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def init_model(gen: torch.Generator, cfg: ModelConfig):
    """(params, specs) of the stack; weights drawn from ``gen`` on its
    device."""
    plan = build_plan(cfg)
    params: dict = {}
    specs: dict = {}
    params["embed"] = truncated_normal(
        gen, (cfg.vocab_size, cfg.d_model), cfg.pdtype,
        1.0 / math.sqrt(cfg.d_model))
    specs["embed"] = ("tp", "fsdp")
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=cfg.pdtype,
                                       device=gen.device)
    specs["final_norm"] = (None,)
    if not cfg.tie_embeddings:
        params["head"] = truncated_normal(
            gen, (cfg.d_model, cfg.vocab_size), cfg.pdtype,
            1.0 / math.sqrt(cfg.d_model))
        specs["head"] = ("fsdp", "tp")
    for si, (unit, count) in enumerate(plan):
        p, s = _stack_init(gen, cfg, unit, count)
        params[f"stack{si}"] = p
        specs[f"stack{si}"] = s
    if cfg.mtp_depth:
        # DeepSeek-V3 multi-token prediction: one extra transformer
        # layer + projection predicting token t+2 from [h_t; emb_{t+1}].
        mp, ms = _init_layer(gen, cfg, ("mla" if cfg.use_mla else "attn",
                                        "dense", 0))
        params["mtp"] = {
            "proj": truncated_normal(gen, (2 * cfg.d_model, cfg.d_model),
                                     cfg.pdtype,
                                     1.0 / math.sqrt(2 * cfg.d_model)),
            "norm": torch.zeros((cfg.d_model,), dtype=cfg.pdtype,
                                device=gen.device),
            "layer": mp,
        }
        specs["mtp"] = {"proj": ("fsdp", None), "norm": (None,),
                        "layer": ms}
    return params, specs


# --------------------------- apply ----------------------------------

def _apply_layer(spec: LayerSpec, prm, x, positions, cfg, rules, cache):
    """One layer: (x, new cache, aux loss [] fp32 of an MoE FFN, else
    None: the layers without one add nothing, and launch nothing)."""
    mixer, ffn_kind, window = spec
    h = rms_norm(x, prm["ln1"], cfg.rmsnorm_eps)
    if mixer == "attn":
        out, new_cache = attn_lib.gqa_attention(
            prm["mixer"], h, positions, cfg, rules, cache=cache,
            window=window)
    elif mixer == "mla":
        out, new_cache = attn_lib.mla_attention(
            prm["mixer"], h, positions, cfg, rules, cache=cache)
    elif mixer == "rglru":
        out, new_cache = rglru_lib.rglru_block(prm["mixer"], h, cfg, rules,
                                               cache)
    elif mixer == "ssd":
        out, new_cache = ssm_lib.ssd_block(prm["mixer"], h, cfg, rules,
                                           cache)
    else:
        raise ValueError(mixer)
    x = x + out
    if ffn_kind == "none":
        return x, new_cache, None
    h = rms_norm(x, prm["ln2"], cfg.rmsnorm_eps)
    if ffn_kind == "moe":
        y, aux = moe_lib.moe(prm["ffn"], h, cfg, rules)
    else:
        y, aux = ffn_lib.ffn(prm["ffn"], h, cfg, rules), None
    return x + y, new_cache, aux


def _run_stack(unit, prm_stack, x, positions, cfg, rules, cache_stack):
    """Loop over the stack's ``count`` units (the reference's scan):
    (x, the units' summed aux loss or None, new caches)."""
    count = tree_leaves(prm_stack)[0].shape[0]
    has_cache = cache_stack is not None

    def body(xc, unit_prm, unit_cache):
        # a unit counts its last slot's aux loss, as the reference's
        # scan body does (every MoE unit of the configs is one layer)
        new_caches = {}
        for j, spec in enumerate(unit):
            c = unit_cache[f"slot{j}"] if has_cache else None
            xc, new_caches[f"slot{j}"], aux = _apply_layer(
                spec, unit_prm[f"slot{j}"], xc, positions, cfg, rules, c)
        return xc, aux, new_caches

    remat = cfg.remat and torch.is_grad_enabled() and not has_cache
    ys = []
    aux_total = None
    for i in range(count):
        unit_prm = tree_map(lambda a, i=i: a[i], prm_stack)
        unit_cache = (tree_map(lambda a, i=i: a[i], cache_stack)
                      if has_cache else None)
        if remat:
            x, aux = checkpoint(
                lambda xc, p=unit_prm: body(xc, p, None)[:2], x,
                use_reentrant=False)
        else:
            x, aux, nc = body(x, unit_prm, unit_cache)
            ys.append(nc)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x, aux_total, (tree_stack(ys) if has_cache else None)


def forward(params, cfg: ModelConfig, rules, tokens=None, *,
            embeds=None, positions=None, caches=None,
            prefix_embeds=None, return_hidden: bool = False):
    """Run the stack.

    tokens [B, S] int32 and/or embeds [B, S, D] (exactly one, or
    prefix_embeds [B, P, D] prepended to token embeddings — the VLM
    path).  caches: list (one entry per stack) or None.
    Returns (logits [B, S', V], new_caches, aux_loss).
    """
    if embeds is None:
        x = params["embed"][tokens.long()]
        if cfg.family in ("vlm",) and prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    else:
        x = embeds.to(cfg.cdtype)
    b, s, _ = x.shape
    x = x.to(cfg.cdtype)
    if cfg.embed_scale:
        x = x * const(math.sqrt(cfg.d_model), x)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    x = constrain(x, ("dp", None, None), rules)

    plan = build_plan(cfg)
    new_caches = []
    aux = torch.zeros((), device=x.device)
    for si, (unit, count) in enumerate(plan):
        cs = caches[si] if caches is not None else None
        x, stack_aux, nc = _run_stack(unit, params[f"stack{si}"], x,
                                      positions, cfg, rules, cs)
        if stack_aux is not None:
            aux = aux + stack_aux
        new_caches.append(nc)
    x = rms_norm(x, params["final_norm"], cfg.rmsnorm_eps)
    head = (params["embed"].T if cfg.tie_embeddings else params["head"])
    logits = torch.einsum("bsd,dv->bsv", x, head.to(x.dtype))
    logits = constrain(logits, ("dp", None, "tp"), rules)
    if return_hidden:
        return logits, (new_caches if caches is not None else None), aux, x
    return logits, (new_caches if caches is not None else None), aux


def mtp_logits(params, cfg: ModelConfig, rules, hidden, next_tokens,
               positions):
    """DeepSeek-V3 MTP head: predict token t+2 from (h_t, emb(t+1))."""
    prm = params["mtp"]
    emb = params["embed"][next_tokens.long()].to(hidden.dtype)
    h = torch.cat([rms_norm(hidden, prm["norm"], cfg.rmsnorm_eps), emb],
                  dim=-1)
    h = torch.einsum("bsd,de->bse", h, prm["proj"])
    spec = ("mla" if cfg.use_mla else "attn", "dense", 0)
    h, _, _ = _apply_layer(spec, prm["layer"], h, positions, cfg, rules,
                           None)
    head = (params["embed"].T if cfg.tie_embeddings else params["head"])
    return torch.einsum("bsd,dv->bsv", h, head.to(h.dtype))


# --------------------------- caches ---------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    """Per-stack stacked caches matching the parameter layout."""
    caches = []
    for unit, count in build_plan(cfg):
        unit_caches = {}
        for j, (mixer, _, window) in enumerate(unit):
            t = min(window, max_len) if window else max_len
            if mixer == "attn":
                c = attn_lib.init_cache_gqa(cfg, batch, t, dtype, device)
            elif mixer == "mla":
                c = attn_lib.init_cache_mla(cfg, batch, t, dtype, device)
            elif mixer == "rglru":
                c = rglru_lib.init_rglru_cache(cfg, batch, dtype, device)
            else:
                c = ssm_lib.init_ssm_cache(cfg, batch, dtype, device)
            unit_caches[f"slot{j}"] = tree_map(
                lambda a, count=count: a[None].expand(
                    count, *a.shape).contiguous(), c)
        caches.append(unit_caches)
    return caches
