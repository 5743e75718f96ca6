"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060) — twin of
``repro.models.ssm``.

Chunked SSD: the sequence is split into chunks of ``ssm_chunk`` tokens;
within a chunk the output is the quadratic (attention-like) masked
kernel, across chunks a recurrent state [H, P, N] is carried by a
Python loop over the chunks (the reference's ``lax.scan``).  Decode is
the recurrent form: one state update per token.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ModelConfig, constrain, rms_norm,
                                       silu, softplus, truncated_normal)


class SSMCache(NamedTuple):
    conv: torch.Tensor    # [B, convw-1, d_conv_in] rolling conv inputs
    state: torch.Tensor   # [B, H, P, N] recurrent SSM state (fp32)
    length: torch.Tensor


def _dims(cfg: ModelConfig):
    d_inner = 2 * cfg.d_model
    p = cfg.ssm_head_dim
    h = d_inner // p
    n = cfg.ssm_state_dim
    return d_inner, h, p, n


def init_ssd(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    d_inner, h, p, n = _dims(cfg)
    conv_in = d_inner + 2 * n
    dev = gen.device
    params = {
        # in_proj -> [z (gate), x, B, C, dt]
        "w_in": truncated_normal(gen, (d, 2 * d_inner + 2 * n + h),
                                 cfg.pdtype, 1.0 / math.sqrt(d)),
        "conv_w": truncated_normal(gen, (cfg.conv_width, conv_in),
                                   cfg.pdtype, 0.5),
        "conv_b": torch.zeros((conv_in,), dtype=cfg.pdtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=dev)),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm": torch.zeros((d_inner,), dtype=cfg.pdtype, device=dev),
        "w_out": truncated_normal(gen, (d_inner, d), cfg.pdtype,
                                  1.0 / math.sqrt(d_inner)),
    }
    specs = {
        "w_in": ("fsdp", "tp"), "conv_w": (None, "tp"), "conv_b": ("tp",),
        "a_log": (None,), "dt_bias": (None,), "d_skip": (None,),
        "norm": ("tp",), "w_out": ("tp", "fsdp"),
    }
    return params, specs


def _taps(u, w):
    """sum_k u[:, k] * w[k] over the K taps of u [B, K, ...], in fp32,
    rounded once to u's dtype (as the reference's bf16 conv)."""
    return (u.float() * w.float()).sum(1).to(u.dtype)


def _causal_conv(u, w, b):
    """Depthwise causal conv: u [B, S, C], w [K, C] -> [B, S, C]."""
    k, s = w.shape[0], u.shape[1]
    u_pad = F.pad(u, (0, 0, k - 1, 0))
    out = sum(u_pad[:, j:j + s].float() * w[j].float() for j in range(k))
    return silu(out.to(u.dtype) + b)


def _ssd_chunked(xh, dt, a, bmat, cmat, chunk: int, state0=None):
    """Chunked SSD scan.

    xh [B,S,H,P], dt [B,S,H] (softplus'd), a [H] (positive decay rate),
    bmat/cmat [B,S,N].  Returns (y [B,S,H,P], final state [B,H,P,N]).
    """
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    nc = s // q
    assert s % q == 0
    da = dt * (-a)[None, None, :]                 # [B,S,H] log-decay (<0)
    xd = xh * dt[..., None]                       # fp32

    xc = xd.reshape(b, nc, q, h, p)
    dac = da.reshape(b, nc, q, h)
    bc = bmat.reshape(b, nc, q, n).float()
    cc = cmat.reshape(b, nc, q, n).float()
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))

    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
             if state0 is None else state0)
    ys = []
    for c in range(nc):
        xq, daq, bq, cq = xc[:, c], dac[:, c], bc[:, c], cc[:, c]
        cum = torch.cumsum(daq, dim=1)            # [B,q,h]
        # within-chunk quadratic term: L[i,j] = exp(cum_i - cum_j) (i>=j),
        # masked before the exp so the backward pass sees no inf
        diff = cum[:, :, None, :] - cum[:, None, :, :]     # [B,q,q,h]
        lmat = torch.exp(torch.where(mask[None, :, :, None], diff, -1e30))
        scores = torch.einsum("bin,bjn->bij", cq, bq)
        w = scores[:, :, :, None] * lmat            # [B, q, q, h]
        y_diag = torch.einsum("bijh,bjhp->bihp", w, xq)
        # contribution of the incoming state
        decay_in = torch.exp(cum)                 # [B,q,h]
        y_off = torch.einsum("bin,bhpn,bih->bihp", cq, state, decay_in)
        # new state = decayed old + chunk contribution
        total = cum[:, -1:, :]                    # [B,1,h]
        decay_out = torch.exp(total - cum)        # [B,q,h]
        state = state * torch.exp(total)[:, 0, :, None, None] + \
            torch.einsum("bjn,bjh,bjhp->bhpn", bq, decay_out, xq)
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y.to(xh.dtype), state


def ssd_block(prm, x, cfg: ModelConfig, rules, cache: SSMCache = None):
    """Mamba-2 mixer. x [B, S, D] -> ([B, S, D], new_cache)."""
    b, s, d = x.shape
    d_inner, h, p, n = _dims(cfg)
    proj = torch.einsum("bsd,de->bse", x, prm["w_in"])
    z, rest = proj[..., :d_inner], proj[..., d_inner:]
    xbc, dt_raw = rest[..., :d_inner + 2 * n], rest[..., d_inner + 2 * n:]

    if cache is not None and s == 1:
        # decode: rolling conv window + O(1) state update
        window = torch.cat([cache.conv, xbc], dim=1)
        conv_out = silu(_taps(window, prm["conv_w"])
                          + prm["conv_b"])[:, None, :]
        new_conv = window[:, 1:, :]
        xh = conv_out[..., :d_inner].reshape(b, 1, h, p)
        bmat = conv_out[..., d_inner:d_inner + n]
        cmat = conv_out[..., d_inner + n:]
        dt = softplus(dt_raw[:, 0, :].float() + prm["dt_bias"])   # [B,H]
        a = torch.exp(prm["a_log"])
        da = torch.exp(-dt * a)                                     # [B,H]
        upd = torch.einsum("bn,bhp,bh->bhpn", bmat[:, 0].float(),
                           xh[:, 0].float(), dt)
        state = cache.state * da[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].float(), state)[:, None]
        y = y.reshape(b, 1, h, p)
        new_cache = SSMCache(new_conv, state, cache.length + 1)
    else:
        conv_out = _causal_conv(xbc, prm["conv_w"], prm["conv_b"])
        xh = conv_out[..., :d_inner].reshape(b, s, h, p)
        bmat = conv_out[..., d_inner:d_inner + n]
        cmat = conv_out[..., d_inner + n:]
        dt = softplus(dt_raw.float() + prm["dt_bias"])
        a = torch.exp(prm["a_log"])
        state0 = cache.state if cache is not None else None
        y, state = _ssd_chunked(xh, dt, a, bmat, cmat, cfg.ssm_chunk, state0)
        if cache is not None:
            tail = xbc[:, -(cfg.conv_width - 1):, :]
            new_cache = SSMCache(tail.to(cache.conv.dtype), state,
                                 cache.length + s)
        else:
            new_cache = None

    y = y.to(x.dtype) + xh.to(x.dtype) * \
        prm["d_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(b, -1, d_inner) * silu(z)
    y = rms_norm(y, prm["norm"], cfg.rmsnorm_eps)
    out = torch.einsum("bse,ed->bsd", y, prm["w_out"])
    return constrain(out, ("dp", None, None), rules), new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device):
    d_inner, h, p, n = _dims(cfg)
    return SSMCache(
        conv=torch.zeros((batch, cfg.conv_width - 1, d_inner + 2 * n),
                         dtype=dtype, device=device),
        state=torch.zeros((batch, h, p, n), dtype=torch.float32,
                          device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))
