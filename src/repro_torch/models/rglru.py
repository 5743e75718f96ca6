"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427) —
twin of ``repro.models.rglru``.

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
a_t = exp(-c * softplus(Lambda) * sigmoid(r_t)),   c = 8

The linear recurrence runs as a log-depth scan in plain PyTorch
operations (:func:`associative_scan`, the even/odd recursion of
``jax.lax.associative_scan`` with the same combine), so a sequence costs
O(log S) launches, not S, and the fp32 results follow the reference's
order of operations.  Decode is a single O(1) state update.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.common import (ModelConfig, constrain, gelu, silu,
                                       softplus, truncated_normal)
from repro_torch.models.ssm import _causal_conv, _taps

_C = 8.0


class RGLRUCache(NamedTuple):
    conv: torch.Tensor    # [B, convw-1, W] rolling conv inputs
    state: torch.Tensor   # [B, W] recurrent hidden state (fp32)
    length: torch.Tensor


def init_rglru(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    w = cfg.lru_width or d
    dev = gen.device
    lin = torch.linspace(0.9, 0.999, w, dtype=torch.float32, device=dev)
    params = {
        "w_x": truncated_normal(gen, (d, w), cfg.pdtype, 1.0 / math.sqrt(d)),
        "w_gate": truncated_normal(gen, (d, w), cfg.pdtype,
                                   1.0 / math.sqrt(d)),
        "conv_w": truncated_normal(gen, (cfg.conv_width, w), cfg.pdtype,
                                   0.5),
        "conv_b": torch.zeros((w,), dtype=cfg.pdtype, device=dev),
        "w_r": truncated_normal(gen, (w, w), cfg.pdtype, 1.0 / math.sqrt(w)),
        "w_i": truncated_normal(gen, (w, w), cfg.pdtype, 1.0 / math.sqrt(w)),
        # Lambda init so a^c spans ~(0.9, 0.999)
        "lam": torch.log(torch.expm1(-torch.log(lin) / _C)),
        "w_out": truncated_normal(gen, (w, d), cfg.pdtype,
                                  1.0 / math.sqrt(w)),
    }
    specs = {"w_x": ("fsdp", "tp"), "w_gate": ("fsdp", "tp"),
             "conv_w": (None, "tp"), "conv_b": ("tp",),
             "w_r": ("tp", None), "w_i": ("tp", None), "lam": (None,),
             "w_out": ("tp", "fsdp")}
    return params, specs


def _gates(prm, u):
    """u [B,S,W] (conv output) -> (a decay fp32, gated input fp32)."""
    r = torch.sigmoid(torch.einsum("bsw,wv->bsv", u, prm["w_r"]).float())
    i = torch.sigmoid(torch.einsum("bsw,wv->bsv", u, prm["w_i"]).float())
    log_a = -_C * softplus(prm["lam"])[None, None, :] * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-9)) * \
        (i * u.float())
    return a, gated


def _combine(lo, hi):
    """(a1, b1) then (a2, b2): (a1 * a2, a2 * b1 + b2)."""
    return lo[0] * hi[0], hi[0] * lo[1] + hi[1]


def _interleave(even, odd):
    """[e0, o0, e1, o1, ...] along axis 1; ``even`` may be one longer."""
    n = odd.shape[1]
    both = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([both, even[:, n:]], dim=1) if even.shape[1] > n \
        else both


def associative_scan(a, b):
    """Inclusive scan of the pairs (a, b) along axis 1 under
    :func:`_combine`: ``jax.lax.associative_scan``'s recursion (pair the
    neighbours, scan the half, fill in the even places), so each output
    is combined in the reference's order."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                     (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    even = (torch.cat([a[:, :1], even[0]], dim=1),
            torch.cat([b[:, :1], even[1]], dim=1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def rglru_block(prm, x, cfg: ModelConfig, rules, cache: RGLRUCache = None):
    """x [B, S, D] -> ([B, S, D], new_cache)."""
    s = x.shape[1]
    xw = torch.einsum("bsd,dw->bsw", x, prm["w_x"])
    gate = gelu(torch.einsum("bsd,dw->bsw", x, prm["w_gate"]))

    if cache is not None and s == 1:
        window = torch.cat([cache.conv, xw], dim=1)
        u = silu(_taps(window, prm["conv_w"]) + prm["conv_b"])[:, None, :]
        a, gated = _gates(prm, u)
        h = a[:, 0] * cache.state + gated[:, 0]
        y = h[:, None, :]
        new_cache = RGLRUCache(window[:, 1:, :], h, cache.length + 1)
    else:
        k = prm["conv_w"].shape[0]
        u = _causal_conv(xw, prm["conv_w"], prm["conv_b"])
        a, gated = _gates(prm, u)
        if cache is not None:
            gated = torch.cat([gated[:, :1] + a[:, :1] * cache.state[:, None],
                               gated[:, 1:]], dim=1)
        _, hh = associative_scan(a, gated)
        y = hh
        if cache is not None:
            tail = xw[:, -(k - 1):, :]
            new_cache = RGLRUCache(tail.to(cache.conv.dtype), hh[:, -1],
                                   cache.length + s)
        else:
            new_cache = None

    y = y.to(x.dtype) * gate
    out = torch.einsum("bsw,wd->bsd", y, prm["w_out"])
    return constrain(out, ("dp", None, None), rules), new_cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device):
    w = cfg.lru_width or cfg.d_model
    return RGLRUCache(
        conv=torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, w), dtype=torch.float32, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))
