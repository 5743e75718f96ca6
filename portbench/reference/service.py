"""Seed queries against a two-half sketch pool, as plain host and
PyTorch arithmetic.

The pool holds ``theta`` samples a half in slabs of ``slab``: slab s of
half h is a draw of ``slab`` samples under ``key.fold_in(h).fold_in(s)
.fold_in(salt)``.  A query (k, excluded vertices, spread budget, eps)
is answered by greedy max-k-cover over half 1 with its excluded
vertices never picked, truncated at the first pick whose running
coverage reaches ceil(budget * theta / n); its seeds' coverage on half 2
bounds the spread from below, its coverage on half 1 over 1 - 1/e bounds
the optimum from above (OPIM-C's bounds, failure probability delta).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import cover


class Answer(NamedTuple):
    seeds: tuple
    k_used: int
    coverage: int
    spread: float
    sigma_lower: float
    sigma_upper: float
    guarantee: float
    certified: bool


def sigma_lower(cov: float, theta: int, n: int, delta: float) -> float:
    a = math.log(1.0 / delta)
    val = (math.sqrt(cov + 2.0 * a / 9.0) - math.sqrt(a / 2.0)) ** 2 \
        - a / 18.0
    return max(val, 0.0) * n / theta


def sigma_upper(cov_ub: float, theta: int, n: int, delta: float) -> float:
    a = math.log(1.0 / delta)
    return (math.sqrt(cov_ub + a / 2.0) + math.sqrt(a / 2.0)) ** 2 \
        * n / theta


def answers(half1: cover.Entries, half2: cover.Entries, queries, *,
            theta: int, delta: float, alpha: float,
            precision: str = "float32") -> list[Answer]:
    """The answers to ``queries`` (each with ``k``, ``excluded``,
    ``budget``, ``eps``), all solved at once, one greedy lane each."""
    n = half1.n
    dev = half1.bits.device
    lanes = len(queries)
    k_max = max(q.k for q in queries)
    taken = torch.zeros((lanes, n), dtype=torch.bool, device=dev)
    for i, q in enumerate(queries):
        if q.excluded:
            taken[i, torch.as_tensor(q.excluded, dtype=torch.int64)] = True
    size = half1.bits.numel()
    lane = torch.arange(lanes, device=dev).repeat_interleave(size)
    picks = cover.greedy(lane, half1.row.repeat(lanes),
                         half1.word.repeat(lanes), half1.bits.repeat(lanes),
                         taken, k_max, half1.words, precision)
    seeds = picks.seeds.cpu().numpy()
    gains = picks.gains.cpu().numpy()
    out = []
    for i, q in enumerate(queries):
        budget = (np.iinfo(np.int32).max if q.budget is None
                  else int(math.ceil(q.budget * theta / n)))
        reached = np.nonzero(np.cumsum(gains[i, :q.k]) >= budget)[0]
        used = int(reached[0]) + 1 if reached.size else q.k
        s = np.where(np.arange(q.k) < used, seeds[i, :q.k], -1)
        valid = s[s >= 0]
        c1 = int(gains[i, :used].sum())
        rows2 = cover.dense_rows(half2, torch.as_tensor(valid, device=dev))
        union = torch.zeros(half2.words, dtype=torch.int64, device=dev)
        for r in rows2:
            union |= r
        c2 = int(cover.popcount(union).sum())
        sig_l = sigma_lower(float(c2), theta, n, delta)
        sig_u = sigma_upper(float(c1) / alpha, theta, n, delta)
        guar = sig_l / max(sig_u, 1e-9)
        certified = guar >= alpha - q.eps or (
            q.budget is not None and sig_l >= q.budget)
        out.append(Answer(tuple(int(x) for x in s), int(valid.size), c1,
                          float(c1) * n / theta, sig_l, sig_u, guar,
                          bool(certified)))
    return out
