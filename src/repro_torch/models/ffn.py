"""Gated FFNs (SwiGLU / GeGLU) — twin of ``repro.models.ffn``."""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import (ModelConfig, act_fn, constrain,
                                       truncated_normal)


def init_ffn(gen: torch.Generator, cfg: ModelConfig, d_ff: int = 0):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    params = {
        "w_gate": truncated_normal(gen, (d, f), cfg.pdtype,
                                   1.0 / math.sqrt(d)),
        "w_up": truncated_normal(gen, (d, f), cfg.pdtype,
                                 1.0 / math.sqrt(d)),
        "w_down": truncated_normal(gen, (f, d), cfg.pdtype,
                                   1.0 / math.sqrt(f)),
    }
    specs = {"w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
             "w_down": ("tp", "fsdp")}
    return params, specs


def ffn(p, x, cfg: ModelConfig, rules):
    a = act_fn(cfg.act)
    h = a(torch.einsum("bsd,df->bsf", x, p["w_gate"])) * \
        torch.einsum("bsd,df->bsf", x, p["w_up"])
    h = constrain(h, ("dp", None, "tp"), rules)
    y = torch.einsum("bsf,fd->bsd", h, p["w_down"])
    return constrain(y, ("dp", None, None), rules)
