"""Gradient compression for slow links — twin of
``repro.optim.compress``.

Top-k sparsification with error feedback: each data-parallel worker
keeps a residual; only the top-k fraction of coordinates (by magnitude)
is exchanged, the rest accumulates into the residual.  Also int8
stochastic quantization (one scale per tensor).

The reference runs :func:`compressed_psum` under a named mesh axis
(``shard_map`` or ``vmap``).  On one card that axis is the leading axis
of every leaf, [M, ...] for M workers, as ``--machines`` is a batch
axis: each worker's slice is compressed on its own and the reduced sum
is returned on every slice, as ``psum`` does.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.prng import Key
from repro_torch.tree import tree_map


class ErrorFeedback(NamedTuple):
    residual: Any  # tree matching grads


def init_error_feedback(grads) -> ErrorFeedback:
    return ErrorFeedback(tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads))


def topk_compress(g: torch.Tensor, frac: float):
    """Keep the top int(frac * size) coords (at least one); return
    (values, idx int32, size).  Ties go to the lower index, as
    ``lax.top_k`` breaks them."""
    flat = g.reshape(-1).float()
    k = max(1, int(frac * flat.shape[0]))
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return flat[idx], idx.to(torch.int32), flat.shape[0]


def topk_decompress(vals, idx, size, shape):
    out = torch.zeros((size,), dtype=torch.float32, device=vals.device)
    out[idx.long()] = vals
    return out.reshape(shape)


def compressed_psum(grads, ef: ErrorFeedback, axis_name, frac: float):
    """The sum over the worker axis (``axis_name`` names the leading
    axis of every leaf) of each worker's top-k compressed gradient.
    Returns (reduced grads, new error feedback), both [M, ...]."""
    def one(g, r):
        acc = g.float() + r
        sent = torch.stack([
            topk_decompress(*topk_compress(acc[j], frac), acc.shape[1:])
            for j in range(acc.shape[0])])
        total = sent[0]
        for j in range(1, sent.shape[0]):
            total = total + sent[j]
        return total.expand_as(sent).clone(), acc - sent

    def walk(g, r):
        if isinstance(g, dict):
            outs = {k: walk(g[k], r[k]) for k in g}
            return ({k: o[0] for k, o in outs.items()},
                    {k: o[1] for k, o in outs.items()})
        return one(g, r)

    red, res = walk(grads, ef.residual)
    return red, ErrorFeedback(res)


def int8_quantize(g: torch.Tensor, key: Key):
    """Stochastic int8 quantization; returns (q, scale).  The noise is
    ``uniform(key, g.shape) - 0.5`` drawn through the port's threefry."""
    scale = g.float().abs().max() / 127.0 + 1e-12
    x = g.float() / scale
    noise = key.uniform(tuple(g.shape), device=g.device) - 0.5
    q = torch.clamp(torch.round(x + noise), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q, scale):
    return q.float() * scale
