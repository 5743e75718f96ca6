"""Greedy max-k-cover, RandGreedi and the bucketed streaming receiver
(McGregor-Vu) over an incidence held as its non-zero words, in plain
PyTorch.

An incidence of ``n`` rows and ``W`` 32-bit words is the triple
``(row, word, bits)`` of its non-zero words, int64 each (``bits`` the
word's unsigned value), rows ascending and words ascending within a row.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.threefry import Key


class Entries(NamedTuple):
    row: torch.Tensor
    word: torch.Tensor
    bits: torch.Tensor
    n: int
    words: int

    def prefix(self, words: int) -> "Entries":
        """The first ``words`` words of every row (the first 32 * words
        samples)."""
        keep = self.word < words
        return Entries(self.row[keep], self.word[keep], self.bits[keep],
                       self.n, words)

    def row_starts(self, rows: int) -> torch.Tensor:
        """int64 [rows + 1]: entry range of each row."""
        counts = torch.bincount(self.row, minlength=rows)
        return torch.nn.functional.pad(torch.cumsum(counts, 0), (1, 0))


def from_pairs(sample: torch.Tensor, vertex: torch.Tensor, n: int,
               theta: int) -> Entries:
    """The incidence of the sets {(sample, vertex)} (distinct pairs)."""
    code = vertex * ((theta + 31) // 32) + sample // 32
    bit = torch.ones_like(sample) << (sample % 32)
    uniq, inv = torch.unique(code, return_inverse=True)
    bits = torch.zeros(uniq.shape, dtype=torch.int64, device=code.device)
    bits.index_add_(0, inv, bit)
    w = (theta + 31) // 32
    return Entries(uniq // w, uniq % w, bits, n, w)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint32 value held in int64."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _rank(gains: torch.Tensor, precision: str) -> torch.Tensor:
    """The values that picks and admissions compare: the gains, or the
    control's bfloat16 roundings of them."""
    if precision == "float32":
        return gains.to(torch.float64)
    return gains.to(torch.bfloat16).to(torch.float64)


class Picks(NamedTuple):
    seeds: torch.Tensor      # int64 [L, k] lane-local index, -1 unused
    gains: torch.Tensor      # int64 [L, k] marginal gain, 0 unused
    covered: torch.Tensor    # int64 [L, W]


def greedy(lane: torch.Tensor, local: torch.Tensor, word: torch.Tensor,
           bits: torch.Tensor, taken: torch.Tensor, k: int, words: int,
           precision: str = "float32") -> Picks:
    """k greedy picks in each of L lanes at once.  Entry e gives lane
    ``lane[e]``'s row ``local[e]`` the word ``bits[e]`` at ``word[e]``;
    ``taken`` bool [L, size] marks rows never picked.  A pick takes the
    largest gain, the lowest row among ties; a best gain <= 0 picks
    nothing (seed -1, gain 0)."""
    n_lanes, size = taken.shape
    dev = bits.device
    taken = taken.clone()
    covered = torch.zeros((n_lanes, words), dtype=torch.int64, device=dev)
    seeds = torch.full((n_lanes, k), -1, dtype=torch.int64, device=dev)
    gains_out = torch.zeros((n_lanes, k), dtype=torch.int64, device=dev)
    slot = lane * size + local
    order = torch.argsort(slot, stable=True)
    lane, local, word, bits, slot = (t[order] for t in
                                     (lane, local, word, bits, slot))
    starts = torch.nn.functional.pad(torch.cumsum(
        torch.bincount(slot, minlength=n_lanes * size), 0), (1, 0))
    lanes = torch.arange(n_lanes, device=dev)
    for i in range(k):
        g = torch.zeros(n_lanes * size, dtype=torch.int64, device=dev)
        g.index_add_(0, slot, popcount(bits & ~covered[lane, word]))
        g = torch.where(taken, -1, g.view(n_lanes, size))
        best = torch.argmax(_rank(g, precision), dim=1)
        best_gain = g[lanes, best]
        take = best_gain > 0
        seeds[:, i] = torch.where(take, best, -1)
        gains_out[:, i] = torch.where(take, best_gain, 0)
        taken[lanes, best] |= take
        first = starts[lanes * size + best]
        count = torch.where(take, starts[lanes * size + best + 1] - first, 0)
        at = torch.repeat_interleave(lanes, count)
        pos = torch.arange(at.numel(), device=dev) \
            - (torch.cumsum(count, 0) - count)[at] + first[at]
        covered[at, word[pos]] |= bits[pos]
    return Picks(seeds, gains_out, covered)


def dense_rows(e: Entries, rows: torch.Tensor) -> torch.Tensor:
    """int64 [len(rows), W]: the words of ``rows`` (-1, or a padding row
    past n, gives zeros)."""
    out = torch.zeros((rows.numel(), e.words), dtype=torch.int64,
                      device=e.bits.device)
    starts = e.row_starts(e.n)
    ok = (rows >= 0) & (rows < e.n)
    r = torch.where(ok, rows, 0)
    count = torch.where(ok, starts[r + 1] - starts[r], 0)
    at = torch.repeat_interleave(torch.arange(rows.numel(),
                                              device=rows.device), count)
    pos = torch.arange(at.numel(), device=rows.device) \
        - (torch.cumsum(count, 0) - count)[at] + starts[r][at]
    out[at, e.word[pos]] = e.bits[pos]
    return out


def num_buckets(k: int, delta: float) -> int:
    return max(1, math.ceil(math.log(max(k, 2)) / math.log1p(delta)))


def _powf(x: float, y: float) -> np.float32:
    """C's float32 ``powf``: the thresholds are stated in float32 as the
    configuration's receiver evaluates them."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.powf.restype = ctypes.c_float
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return np.float32(libm.powf(x, y))


def thresholds(k: int, delta: float, lower: float, b: int) -> np.ndarray:
    """float32 [b]: lower * (1 + delta)^i / (2k), in float32 steps (the
    power by powf, the division as a product with the reciprocal)."""
    base = np.float32(1.0 + delta)
    pows = np.array([_powf(float(base), float(np.float32(i)))
                     for i in range(b)], dtype=np.float32)
    recip = np.float32(1.0) / np.float32(2.0 * k)
    return (np.float32(lower) * pows) * recip


def stream(ids: torch.Tensor, rows: torch.Tensor, k: int, delta: float,
           lower: float, precision: str = "float32"):
    """One streaming pass of candidates (ids [T], -1 skipped; rows
    [T, W]) through the threshold buckets -> (seeds [k], coverage) of
    the bucket covering most (the first among ties)."""
    b = num_buckets(k, delta)
    thr = torch.from_numpy(thresholds(k, delta, lower, b)).to(rows.device)
    thr = thr.to(torch.float64) if precision == "float32" else \
        thr.to(torch.bfloat16).to(torch.float64)
    covers = torch.zeros((b, rows.shape[1]), dtype=torch.int64,
                         device=rows.device)
    counts = torch.zeros(b, dtype=torch.int64, device=rows.device)
    seeds = torch.full((b, k), -1, dtype=torch.int64, device=rows.device)
    ar = torch.arange(b, device=rows.device)
    for c, cid in enumerate(ids.tolist()):
        if cid < 0:
            continue
        row = rows[c]
        gain = popcount(row & ~covers).sum(1)
        accept = (counts < k) & (_rank(gain, precision) >= thr)
        covers = torch.where(accept[:, None], covers | row, covers)
        at = counts.clamp(max=k - 1)
        seeds[ar, at] = torch.where(accept, cid, seeds[ar, at])
        counts = counts + accept.to(torch.int64)
    per = popcount(covers).sum(1)
    best = int(torch.argmax(per))
    return seeds[best], int(per[best])


def randgreedi(e: Entries, key: Key, *, m: int, k: int, delta: float,
               precision: str = "float32"):
    """RandGreedi with the streaming receiver: the rows (padded with
    empty rows to a multiple of m) cut by a uniform permutation into m
    blocks, k greedy picks on each, the m * k picks streamed machine by
    machine through the buckets; the better of the receiver's seeds and
    the best machine's.  -> (seeds int64 [k], -1 unused; coverage)."""
    dev = e.bits.device
    n_pad = -(-e.n // m) * m
    per = n_pad // m
    assign = key.permutation(n_pad, device=dev).view(m, per)
    machine = torch.empty(n_pad, dtype=torch.int64, device=dev)
    local = torch.empty(n_pad, dtype=torch.int64, device=dev)
    machine[assign] = torch.arange(m, device=dev)[:, None].expand(m, per)
    local[assign] = torch.arange(per, device=dev)[None].expand(m, per)
    taken = torch.zeros((m, per), dtype=torch.bool, device=dev)
    picks = greedy(machine[e.row], local[e.row], e.word, e.bits, taken, k,
                   e.words, precision)
    ids = torch.where(picks.seeds >= 0,
                      torch.gather(assign, 1, picks.seeds.clamp(min=0)), -1)
    local_cov = popcount(picks.covered).sum(1)
    sent = ids.reshape(-1)
    lower = float(picks.gains[:, 0].max())
    g_seeds, g_cov = stream(sent, dense_rows(e, sent), k, delta, lower,
                            precision)
    best_m = int(torch.argmax(local_cov))
    if g_cov >= int(local_cov[best_m]):
        seeds, cov = g_seeds, g_cov
    else:
        seeds, cov = ids[best_m], int(local_cov[best_m])
    return torch.where(seeds < e.n, seeds, -1), cov
