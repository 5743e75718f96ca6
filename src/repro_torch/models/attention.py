"""Attention blocks: GQA/MQA/MHA, MLA (DeepSeek), local windows and
position-explicit caches — twin of ``repro.models.attention``.

``chunked_attention`` is the reference's blockwise formulation in plain
PyTorch operations: for each query block, a loop over key blocks with a
running max and denominator in fp32, so no [Sq, Skv] score matrix is
built.  The reference computes attention outside any Pallas kernel, and
so does the port.

Caches are position-explicit ring buffers: slot i stores absolute
position ``pos[i]`` (``EMPTY_POS`` = empty, masked out by the causal
test), so windowed architectures decode against a fixed buffer.

MLA decode uses the *absorbed* formulation: q_nope is folded through
the k up-projection so the per-step attention runs directly against
the compressed c_kv cache — the cache stays [S, kv_lora + rope] per
token instead of [S, 2 * H * head_dim].
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models.common import (ModelConfig, apply_rope, constrain,
                                       make_rope, rms_norm, truncated_normal)

EMPTY_POS = 1 << 30


class KVCache(NamedTuple):
    k: torch.Tensor       # [B, T, KVH, hd]   (MLA: c_kv [B, T, kv_lora])
    v: torch.Tensor       # [B, T, KVH, hd]   (MLA: k_rope [B, T, rope])
    pos: torch.Tensor     # int32 [T] absolute position per slot
    length: torch.Tensor  # int32 [] total tokens ever written


def _cache_write(cache: KVCache, k_new, v_new, positions):
    """Write s new tokens.  s == 1 uses a ring slot (len % T); s > 1
    (prefill) writes the last min(s, T) tokens at the buffer head."""
    s = k_new.shape[1]
    t = cache.k.shape[1]
    if s == 1:
        slot = torch.remainder(cache.length, t).reshape(1).long()
        k = cache.k.index_copy(1, slot, k_new.to(cache.k.dtype))
        v = cache.v.index_copy(1, slot, v_new.to(cache.v.dtype))
        pos = cache.pos.index_copy(0, slot, positions.to(torch.int32))
    else:
        keep = min(s, t)
        k, v, pos = cache.k.clone(), cache.v.clone(), cache.pos.clone()
        k[:, :keep] = k_new[:, -keep:].to(k.dtype)
        v[:, :keep] = v_new[:, -keep:].to(v.dtype)
        pos[:keep] = positions[-keep:].to(torch.int32)
    return KVCache(k, v, pos, cache.length + s)


# --------------------------------------------------------------------
# chunked (flash-style) grouped attention
# --------------------------------------------------------------------

def _f32_einsum(eq, a, b):
    """``jnp.einsum(..., preferred_element_type=float32)``: the products
    of the inputs summed in fp32."""
    return torch.einsum(eq, a.float(), b.float())


def chunked_attention(q, k, v, *, q_pos, kv_pos, causal: bool,
                      window: int = 0, scale: float, q_chunk: int = 1024,
                      kv_chunk: int = 1024):
    """Grouped-query attention without materializing [Sq, Skv].

    q: [B, Sq, H, dk]; k: [B, Skv, KVH, dk]; v: [B, Skv, KVH, dv].
    q_pos [Sq], kv_pos [Skv] are absolute positions for masking
    (kv_pos == EMPTY_POS marks unwritten cache slots).
    """
    b, sq, h, dk = q.shape
    skv, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kvh
    qc = sq if sq < q_chunk else q_chunk
    kc = skv if skv < kv_chunk else kv_chunk
    while sq % qc:
        qc //= 2
    while skv % kc:
        kc //= 2
    nq, nk = sq // qc, skv // kc

    qg = q.reshape(b, nq, qc, kvh, g, dk).permute(1, 0, 3, 4, 2, 5)
    kr = k.reshape(b, nk, kc, kvh, dk).permute(1, 0, 3, 2, 4)
    vr = v.reshape(b, nk, kc, kvh, dv).permute(1, 0, 3, 2, 4)
    qp = q_pos.reshape(nq, qc)
    kp = kv_pos.reshape(nk, kc)

    outs = []
    for i in range(nq):
        qpos, qb = qp[i], qg[i]          # [qc], [B, KVH, G, qc, dk]
        m = torch.full((b, kvh, g, qc), -1e30, dtype=torch.float32,
                       device=q.device)
        den = torch.zeros((b, kvh, g, qc), dtype=torch.float32,
                          device=q.device)
        acc = torch.zeros((b, kvh, g, qc, dv), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            kpos, kb, vb = kp[j], kr[j], vr[j]
            s = _f32_einsum("bkgqd,bkcd->bkgqc", qb, kb) * scale
            mask = (kpos[None, :] < EMPTY_POS).expand(qc, kc)
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            if window:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            den = den * corr + p.sum(-1)
            acc = acc * corr[..., None] + _f32_einsum(
                "bkgqc,bkcv->bkgqv", p.to(vb.dtype), vb)
            m = m_new
        outs.append(acc / den[..., None].clamp_min(1e-30))
    out = torch.stack(outs)              # [nq, B, KVH, G, qc, dv]
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, dv)
    return out.to(v.dtype)


# --------------------------------------------------------------------
# GQA block
# --------------------------------------------------------------------

def init_gqa(gen: torch.Generator, cfg: ModelConfig):
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sc = 1.0 / math.sqrt(d)
    params = {
        "wq": truncated_normal(gen, (d, h, hd), cfg.pdtype, sc),
        "wk": truncated_normal(gen, (d, kvh, hd), cfg.pdtype, sc),
        "wv": truncated_normal(gen, (d, kvh, hd), cfg.pdtype, sc),
        "wo": truncated_normal(gen, (h, hd, d), cfg.pdtype,
                               1.0 / math.sqrt(h * hd)),
    }
    specs = {
        "wq": ("fsdp", "tp", None), "wk": ("fsdp", "tp", None),
        "wv": ("fsdp", "tp", None), "wo": ("tp", None, "fsdp"),
    }
    if cfg.qkv_bias:
        dev = gen.device
        params.update({
            "bq": torch.zeros((h, hd), dtype=cfg.pdtype, device=dev),
            "bk": torch.zeros((kvh, hd), dtype=cfg.pdtype, device=dev),
            "bv": torch.zeros((kvh, hd), dtype=cfg.pdtype, device=dev),
        })
        specs.update({"bq": ("tp", None), "bk": ("tp", None),
                      "bv": ("tp", None)})
    return params, specs


def gqa_attention(p, x, positions, cfg: ModelConfig, rules, *,
                  cache: Optional[KVCache] = None, causal: bool = True,
                  window: int = 0, kv_x: Optional[torch.Tensor] = None,
                  kv_positions=None, rope: bool = True):
    """x [B, S, D], positions int32 [S]; returns ([B, S, D], new_cache).

    kv_x switches to cross-attention (the cache is then not written).
    """
    cross = kv_x is not None
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if rope and not cross:
        sin, cos = make_rope(positions, cfg.head_dim, cfg.rope_theta,
                             x.dtype)
        q = apply_rope(q, sin, cos)
    q = constrain(q, ("dp", None, "tp", None), rules)

    src = kv_x if cross else x
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    if rope and not cross:
        k = apply_rope(k, sin, cos)
    k = constrain(k, ("dp", None, "tp", None), rules)

    scale = 1.0 / math.sqrt(cfg.head_dim)
    if cache is not None and not cross:
        new_cache = _cache_write(cache, k, v, positions)
        out = chunked_attention(
            q, new_cache.k.to(k.dtype), new_cache.v.to(v.dtype),
            q_pos=positions, kv_pos=new_cache.pos, causal=causal,
            window=window, scale=scale, q_chunk=cfg.q_chunk,
            kv_chunk=cfg.kv_chunk)
    else:
        new_cache = cache
        kvp = (kv_positions if kv_positions is not None else
               torch.arange(src.shape[1], device=x.device))
        out = chunked_attention(q, k, v, q_pos=positions, kv_pos=kvp,
                                causal=causal and not cross, window=window,
                                scale=scale, q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return constrain(y, ("dp", None, None), rules), new_cache


def init_cache_gqa(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device):
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((max_len,), EMPTY_POS, dtype=torch.int32,
                       device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))


# --------------------------------------------------------------------
# MLA block (DeepSeek-V3)
# --------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig):
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    sc = 1.0 / math.sqrt(d)
    zeros = dict(dtype=cfg.pdtype, device=gen.device)
    params = {
        "wq_a": truncated_normal(gen, (d, qr), cfg.pdtype, sc),
        "q_norm": torch.zeros((qr,), **zeros),
        "wq_b": truncated_normal(gen, (qr, h, nd + rd), cfg.pdtype,
                                 1.0 / math.sqrt(qr)),
        "wkv_a": truncated_normal(gen, (d, kvr + rd), cfg.pdtype, sc),
        "kv_norm": torch.zeros((kvr,), **zeros),
        "wk_b": truncated_normal(gen, (kvr, h, nd), cfg.pdtype,
                                 1.0 / math.sqrt(kvr)),
        "wv_b": truncated_normal(gen, (kvr, h, vd), cfg.pdtype,
                                 1.0 / math.sqrt(kvr)),
        "wo": truncated_normal(gen, (h, vd, d), cfg.pdtype,
                               1.0 / math.sqrt(h * vd)),
    }
    specs = {
        "wq_a": ("fsdp", None), "q_norm": (None,),
        "wq_b": ("fsdp", "tp", None),
        "wkv_a": ("fsdp", None), "kv_norm": (None,),
        "wk_b": (None, "tp", None), "wv_b": (None, "tp", None),
        "wo": ("tp", None, "fsdp"),
    }
    return params, specs


def mla_attention(p, x, positions, cfg: ModelConfig, rules, *,
                  cache: Optional[KVCache] = None):
    """MLA; cache holds (c_kv [B,T,kvr], k_rope [B,T,rd], pos [T]).
    Prefill and forward expand K and V from c_kv and attend blockwise;
    a one-token decode against a cache attends in the kv_lora space."""
    s = x.shape[1]
    nd, rd = cfg.qk_nope_dim, cfg.qk_rope_dim
    scale = 1.0 / math.sqrt(nd + rd)

    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wq_a"]), p["q_norm"],
                  cfg.rmsnorm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"])
    qn, qr_ = q[..., :nd], q[..., nd:]
    ckv_full = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    ckv = rms_norm(ckv_full[..., :cfg.kv_lora_rank], p["kv_norm"],
                   cfg.rmsnorm_eps)
    krope = ckv_full[..., cfg.kv_lora_rank:]
    sin, cos = make_rope(positions, rd, cfg.rope_theta, x.dtype)
    qr_ = apply_rope(qr_, sin, cos)
    krope = apply_rope(krope[:, :, None, :], sin, cos)[:, :, 0, :]

    new_cache = (_cache_write(cache, ckv, krope, positions)
                 if cache is not None else None)

    if cache is not None and s == 1:
        # absorbed decode in the compressed kv_lora space: bf16
        # products, fp32 sums for the two score terms
        ckv_all, kr_all, kv_pos = new_cache.k, new_cache.v, new_cache.pos
        q_abs = torch.einsum("bshn,rhn->bshr", qn, p["wk_b"])
        s_c = _f32_einsum("bshr,btr->bhst", q_abs,
                          ckv_all.to(q_abs.dtype))
        s_r = _f32_einsum("bshk,btk->bhst", qr_, kr_all.to(qr_.dtype))
        logits = (s_c + s_r) * scale
        valid = kv_pos[None, :] <= positions[..., -1:]
        logits = torch.where(valid[:, None, None, :], logits, -1e30)
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhst,btr->bshr", w, ckv_all.to(x.dtype))
        out = torch.einsum("bshr,rhv->bshv", ctx, p["wv_b"])
    else:
        k_nope = torch.einsum("btr,rhn->bthn", ckv, p["wk_b"])
        v = torch.einsum("btr,rhv->bthv", ckv, p["wv_b"])
        k = torch.cat([k_nope, krope[:, :, None, :].expand(
            *k_nope.shape[:3], rd)], dim=-1)
        qfull = torch.cat([qn, qr_], dim=-1)
        out = chunked_attention(qfull, k, v, q_pos=positions,
                                kv_pos=positions, causal=True, scale=scale,
                                q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    y = torch.einsum("bshv,hvd->bsd", out, p["wo"])
    return constrain(y, ("dp", None, None), rules), new_cache


def init_cache_mla(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device):
    return KVCache(
        k=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                      device=device),
        pos=torch.full((max_len,), EMPTY_POS, dtype=torch.int32,
                       device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))
