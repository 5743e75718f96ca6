"""Routed mixture-of-experts layer (DeepSeek-V3 / Qwen3-MoE style) — twin
of ``repro.models.moe``.

Token dispatch is the grouped capacity-factor one-hot formulation
(Switch/MaxText style): tokens are reshaped into groups of ``moe_group``
tokens and capacity is per group, so the dispatch tensor is
[G, tg, E, C] with C = tg*k/E*cf, linear in the total token count.  On
one card the expert axis is a batch axis of plain batched products; the
reference computes them outside any kernel, and so does the port.

A shared-expert branch (DeepSeek: 1 shared + 256 routed, top-8) runs as
a plain dense FFN in parallel.  The router adds the standard
load-balance auxiliary loss; capacity overflow drops tokens (their
residual passes through).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import (ModelConfig, act_fn, constrain,
                                       truncated_normal)
from repro_torch.models.ffn import ffn, init_ffn

MOE_GROUP = 512  # tokens per dispatch group


def init_moe(gen: torch.Generator, cfg: ModelConfig):
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    params = {
        "router": truncated_normal(gen, (d, e), torch.float32,
                                   1.0 / math.sqrt(d)),
        "w_gate": truncated_normal(gen, (e, d, f), cfg.pdtype,
                                   1.0 / math.sqrt(d)),
        "w_up": truncated_normal(gen, (e, d, f), cfg.pdtype,
                                 1.0 / math.sqrt(d)),
        "w_down": truncated_normal(gen, (e, f, d), cfg.pdtype,
                                   1.0 / math.sqrt(f)),
    }
    specs = {
        "router": (None, None),
        "w_gate": ("tp", "fsdp", None),
        "w_up": ("tp", "fsdp", None),
        "w_down": ("tp", None, "fsdp"),
    }
    if cfg.num_shared_experts:
        sp, ss = init_ffn(gen, cfg,
                          d_ff=cfg.moe_d_ff * cfg.num_shared_experts)
        params["shared"] = sp
        specs["shared"] = ss
    return params, specs


def top_k(probs, k: int):
    """``lax.top_k`` over the last axis: the k largest values, highest
    first, the lower index first among equal values (a stable descending
    sort, so the order is (-p, index))."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, xt, cfg: ModelConfig):
    """The router of the groups ``xt`` [g, tg, D]: (probs [g, tg, E]
    fp32, gate values [g, tg, k] renormalised, the experts one-hot
    [g, tg, k, E] fp32, slot positions [g, tg, k] (fp32, each one's rank
    among its expert's slots in the group), keep mask [g, tg, k],
    capacity)."""
    g, tg, _ = xt.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = torch.einsum("gtd,de->gte", xt.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, k)                 # [g, tg, k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    cap = max(k, int(tg * k / e * cfg.capacity_factor))
    onehot = torch.nn.functional.one_hot(expert_idx, e).float()
    flat_oh = onehot.reshape(g, tg * k, e)
    pos_in_e = torch.cumsum(flat_oh, dim=1) * flat_oh - 1.0
    pos = pos_in_e.amax(-1).reshape(g, tg, k)               # [g, tg, k]
    keep = (pos < cap) & (pos >= 0)
    return probs, gate_vals, onehot, pos, keep, cap


def moe(p, x, cfg: ModelConfig, rules):
    """x [B, S, D] -> ([B, S, D], aux_loss)."""
    b, s, d = x.shape
    e = cfg.num_experts
    t = b * s
    tg = min(cfg.moe_group or MOE_GROUP, t)
    g = t // tg
    assert t % tg == 0, (t, tg)
    xt = x.reshape(g, tg, d)
    xt = constrain(xt, ("dp", None, None), rules)

    probs, gate_vals, onehot, pos, keep, cap = route(p, xt, cfg)

    # load-balance aux loss (Switch): e * sum_e f_e * p_e
    frac_tokens = onehot.sum(2).mean((0, 1))
    frac_probs = probs.mean((0, 1))
    aux = e * (frac_tokens * frac_probs).sum()

    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    slot = torch.where(keep, pos, float(cap)).long()
    pos_oh = torch.nn.functional.one_hot(slot, cap + 1).to(
        cfg.cdtype)[..., :cap]                              # [g, tg, k, c]

    oh = onehot.to(cfg.cdtype)
    dispatch = torch.einsum("gtke,gtkc->gtec", oh, pos_oh)  # [g, tg, e, c]
    # the reference's "gtke,gtkc,gtk->gtec": each (t, e, c) has at most
    # one non-zero term, 1 * 1 * gate, so any order gives its bits
    combine = torch.einsum("gtke,gtkc->gtec", oh,
                           pos_oh * gate_vals.to(cfg.cdtype)[..., None])

    xe = torch.einsum("gtd,gtec->gecd", xt.to(cfg.cdtype), dispatch)
    xe = constrain(xe, ("dp", "tp", None, None), rules)
    a = act_fn(cfg.act)
    h = a(torch.einsum("gecd,edf->gecf", xe, p["w_gate"])) * \
        torch.einsum("gecd,edf->gecf", xe, p["w_up"])
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    ye = constrain(ye, ("dp", "tp", None, None), rules)
    y = torch.einsum("gecd,gtec->gtd", ye, combine)

    if cfg.num_shared_experts:
        y = y + ffn(p["shared"], x, cfg, rules).reshape(g, tg, d)
    return constrain(y.reshape(b, s, d), ("dp", None, None), rules), aux
