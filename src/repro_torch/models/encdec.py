"""Encoder-decoder stack (SeamlessM4T-large-v2 transformer backbone) —
twin of ``repro.models.encdec``.

The modality frontend is a stub: the caller provides precomputed frame
embeddings [B, S_enc, D].  The encoder is a bidirectional attention
stack; the decoder interleaves causal self-attention, cross-attention
over the encoder output, and FFN.  Decode caches the self-attention KV;
cross-attention keys are recomputed from the encoder output.  Both
stacks carry a leading [count] axis on every leaf and run as a Python
loop over their layers (the reference's scans), under
``torch.utils.checkpoint`` with ``cfg.remat`` and gradients on.  The
reference's ``cache_specs`` builds JAX ``PartitionSpec`` objects for a
device mesh, which has no object on one card: it is not ported.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn as ffn_lib
from repro_torch.models.common import (ModelConfig, constrain, rms_norm,
                                       truncated_normal)
from repro_torch.models.transformer import _map_specs
from repro_torch.tree import tree_leaves, tree_map, tree_stack


def _norms(cfg, gen, names):
    return {n: torch.zeros((cfg.d_model,), dtype=cfg.pdtype,
                           device=gen.device) for n in names}


def _init_enc_layer(gen, cfg):
    mp, ms = attn_lib.init_gqa(gen, cfg)
    fp, fs = ffn_lib.init_ffn(gen, cfg)
    return ({"attn": mp, "ffn": fp, **_norms(cfg, gen, ("ln1", "ln2"))},
            {"attn": ms, "ffn": fs, "ln1": (None,), "ln2": (None,)})


def _init_dec_layer(gen, cfg):
    sp, ss = attn_lib.init_gqa(gen, cfg)
    cp, cs = attn_lib.init_gqa(gen, cfg)
    fp, fs = ffn_lib.init_ffn(gen, cfg)
    return ({"self": sp, "cross": cp, "ffn": fp,
             **_norms(cfg, gen, ("ln1", "ln2", "ln3"))},
            {"self": ss, "cross": cs, "ffn": fs,
             "ln1": (None,), "ln2": (None,), "ln3": (None,)})


def _stack(gen, count, init_one, cfg):
    """``count`` layers from ``init_one``, every leaf with a leading
    [count] axis (``count == 1`` included)."""
    layers = [init_one(gen, cfg) for _ in range(count)]
    params = tree_stack([p for p, _ in layers])
    specs = _map_specs(lambda sp: (None, *sp), layers[0][1])
    return params, specs


def init_model(gen: torch.Generator, cfg: ModelConfig):
    """(params, specs); weights drawn from ``gen`` on its device."""
    params = {
        "embed": truncated_normal(gen, (cfg.vocab_size, cfg.d_model),
                                  cfg.pdtype, 1.0 / math.sqrt(cfg.d_model)),
        **_norms(cfg, gen, ("enc_norm", "dec_norm")),
        "head": truncated_normal(gen, (cfg.d_model, cfg.vocab_size),
                                 cfg.pdtype, 1.0 / math.sqrt(cfg.d_model)),
    }
    specs = {"embed": ("tp", "fsdp"), "enc_norm": (None,),
             "dec_norm": (None,), "head": ("fsdp", "tp")}
    params["encoder"], specs["encoder"] = _stack(
        gen, cfg.encoder_layers, _init_enc_layer, cfg)
    params["decoder"], specs["decoder"] = _stack(
        gen, cfg.num_layers, _init_dec_layer, cfg)
    return params, specs


def _layers(stack):
    count = tree_leaves(stack)[0].shape[0]
    return [tree_map(lambda a, i=i: a[i], stack) for i in range(count)]


def encode(params, cfg: ModelConfig, rules, frames):
    """frames [B, S_enc, D] (stub frontend output) -> [B, S_enc, D]."""
    x = frames.to(cfg.cdtype)
    x = constrain(x, ("dp", None, None), rules)
    positions = torch.arange(x.shape[1], device=x.device)

    def body(xc, prm):
        h = rms_norm(xc, prm["ln1"], cfg.rmsnorm_eps)
        out, _ = attn_lib.gqa_attention(prm["attn"], h, positions, cfg,
                                        rules, causal=False)
        xc = xc + out
        h = rms_norm(xc, prm["ln2"], cfg.rmsnorm_eps)
        return xc + ffn_lib.ffn(prm["ffn"], h, cfg, rules)

    remat = cfg.remat and torch.is_grad_enabled()
    for prm in _layers(params["encoder"]):
        x = (checkpoint(body, x, prm, use_reentrant=False) if remat
             else body(x, prm))
    return rms_norm(x, params["enc_norm"], cfg.rmsnorm_eps)


def decode(params, cfg: ModelConfig, rules, tokens, enc_out, *,
           positions=None, caches=None):
    """tokens [B, S_dec]; enc_out [B, S_enc, D].
    Returns (logits, new_caches)."""
    x = params["embed"][tokens.long()].to(cfg.cdtype)
    x = constrain(x, ("dp", None, None), rules)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=x.device)
    enc_pos = torch.arange(enc_out.shape[1], device=x.device)

    def body(xc, prm, cache):
        h = rms_norm(xc, prm["ln1"], cfg.rmsnorm_eps)
        out, nc = attn_lib.gqa_attention(prm["self"], h, positions, cfg,
                                         rules, cache=cache)
        xc = xc + out
        h = rms_norm(xc, prm["ln2"], cfg.rmsnorm_eps)
        out, _ = attn_lib.gqa_attention(prm["cross"], h, positions, cfg,
                                        rules, kv_x=enc_out,
                                        kv_positions=enc_pos)
        xc = xc + out
        h = rms_norm(xc, prm["ln3"], cfg.rmsnorm_eps)
        return xc + ffn_lib.ffn(prm["ffn"], h, cfg, rules), nc

    remat = cfg.remat and torch.is_grad_enabled() and caches is None
    layers = _layers(params["decoder"])
    ys = []
    for i, prm in enumerate(layers):
        if remat:
            x = checkpoint(lambda xc, p=prm: body(xc, p, None)[0], x,
                           use_reentrant=False)
            continue
        cache = (tree_map(lambda a, i=i: a[i], caches)
                 if caches is not None else None)
        x, nc = body(x, prm, cache)
        ys.append(nc)
    x = rms_norm(x, params["dec_norm"], cfg.rmsnorm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, params["head"].to(x.dtype))
    logits = constrain(logits, ("dp", None, "tp"), rules)
    return logits, (tree_stack(ys) if caches is not None else None)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    """One self-attention ``KVCache`` whose leaves are stacked over the
    decoder's layers: [num_layers, ...]."""
    c = attn_lib.init_cache_gqa(cfg, batch, max_len, dtype, device)
    return tree_map(lambda a: a[None].expand(cfg.num_layers,
                                             *a.shape).contiguous(), c)
