"""Packed-bitset algebra on int32 words.

An incidence matrix X over (n vertices x theta samples) is stored as
int32 words holding uint32 bit patterns: X[v, w] has bit j set iff
vertex v appears in RRR sample (w * 32 + j).  torch has no uint32
shifts or ``bitwise_not`` on the CPU, so words stay int32; every right
shift that must be logical is masked, and the plain popcount is a SWAR
popcount in int64 (the CUDA kernels use ``__popc``).
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
WORD_DTYPE = torch.int32


def num_words(num_bits: int) -> int:
    """Number of 32-bit words needed to hold ``num_bits`` bits."""
    return (int(num_bits) + WORD_BITS - 1) // WORD_BITS


def to_words(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 words with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(WORD_DTYPE)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a bool [..., 32] axis into int32 words: bit j <- bits[..., j]."""
    shifts = torch.arange(WORD_BITS, device=bits.device)
    return to_words((bits.to(torch.int64) << shifts).sum(-1))


def pack_bool_matrix(dense: torch.Tensor) -> torch.Tensor:
    """Pack a bool matrix [n, theta] into int32 words [n, ceil(theta/32)].

    Bit j of word w corresponds to column (w * 32 + j).
    """
    n, theta = dense.shape
    w = num_words(theta)
    pad = w * WORD_BITS - theta
    if pad:
        dense = torch.nn.functional.pad(dense, (0, pad))
    return pack_bits(dense.reshape(n, w, WORD_BITS))


def lane_words(num_bits: int, device) -> torch.Tensor:
    """int32 [num_words(num_bits)]: bit j of word w set iff w*32+j <
    num_bits (the simulation lanes of a cascade's row)."""
    return pack_bool_matrix(
        torch.ones((1, num_bits), dtype=torch.bool, device=device))[0]


def unpack_words(words: torch.Tensor, theta: int) -> torch.Tensor:
    """Inverse of :func:`pack_bool_matrix` -> bool [..., theta]."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    flat = bits.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS)
    return flat[..., :theta].to(torch.bool)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word population count (int32 words in, int32 out)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def coverage_size(words: torch.Tensor) -> torch.Tensor:
    """Total number of set bits along the last (word) axis, int32."""
    return popcount(words).sum(-1, dtype=torch.int32)


def marginal_gain(rows: torch.Tensor, covered: torch.Tensor) -> torch.Tensor:
    """popcount(rows & ~covered) summed over words -> int32 [...]."""
    return coverage_size(rows & ~covered)


def union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bitwise OR of two packed word arrays (the union of their sets)."""
    return a | b


def or_reduce(words: torch.Tensor, axis: int) -> torch.Tensor:
    """Bitwise-OR reduction of packed words along ``axis`` (exact in any
    order; an empty axis reduces to zero words)."""
    axis = axis % words.dim()
    out = torch.zeros(words.shape[:axis] + words.shape[axis + 1:],
                      dtype=words.dtype, device=words.device)
    for part in words.unbind(axis):
        out |= part
    return out


def packed_nonzero(words: torch.Tensor, *, size: int, fill_value: int = -1):
    """(sample, vertex) pairs of the set bits of packed words [n, W],
    int32 [size] each, sample-major (then vertex), tail filled with
    ``fill_value`` — the reference's order exactly: each of the 32
    bit-planes contributes its first ``size`` hits in (vertex, word)
    order, and the merged pairs are sorted by (sample, vertex)."""
    n = words.shape[0]
    s_all, v_all = [], []
    for j in range(WORD_BITS):
        v_j, w_j = torch.nonzero((words >> j) & 1, as_tuple=True)
        s_all.append(w_j[:size] * WORD_BITS + j)
        v_all.append(v_j[:size])
    s_cat, v_cat = torch.cat(s_all), torch.cat(v_all)
    order = torch.argsort(s_cat * max(n, 1) + v_cat)[:size]
    s_out = torch.full((size,), fill_value, dtype=torch.int32,
                       device=words.device)
    v_out = s_out.clone()
    s_out[:order.numel()] = s_cat[order].to(torch.int32)
    v_out[:order.numel()] = v_cat[order].to(torch.int32)
    return s_out, v_out


def pack_indices(indices, theta: int) -> torch.Tensor:
    """Pack a list of sample indices into one int32 word row (CPU)."""
    w = num_words(theta)
    row = np.zeros(w, dtype=np.uint32)
    idx = np.asarray(indices, dtype=np.int64)
    np.bitwise_or.at(row, idx // WORD_BITS,
                     np.uint32(1) << (idx % WORD_BITS).astype(np.uint32))
    return torch.from_numpy(row.view(np.int32))
