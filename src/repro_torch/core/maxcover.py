"""Greedy max-k-cover over packed incidence rows (twin of
``repro.core.maxcover``).

The reference's solver quad, bit-identical to each other and to the
reference (seeds, rows, covered, gains — with the lowest-index argmax
tie-break):

  * ``solver="scan"`` — one full marginal-gain sweep + ``argmax`` per
    pick in plain PyTorch;
  * ``solver="fused"`` — one launch of the ``kernels.topk_gain`` CUDA
    kernel per pick (gain sweep + argmax), committed on the device;
  * ``solver="resident"`` — all k picks of every machine in one launch
    of the ``kernels.greedy_pick`` CUDA kernel;
  * ``solver="lazy"`` — the resident launch plus stale per-tile upper
    bounds (``kernels.lazy_greedy``), re-sweeping only the tiles that
    can still win.

Rows may carry a leading machine axis ([m, n, W]); the m solves are
then independent (RandGreedi's local machines) and run together.
:func:`greedy_maxcover_batch` solves B seed-constrained queries over one
shared [n, W] pool (serving) the same way, the pool never copied.
"""
from __future__ import annotations

import heapq
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.kernels import greedy_pick, lazy_greedy, topk_gain

SOLVERS = ("scan", "fused", "resident", "lazy")


class CoverSolution(NamedTuple):
    seeds: torch.Tensor      # int32 [..., k] selected row indices (-1 = unused)
    rows: torch.Tensor       # int32 [..., k, W] covering rows of the seeds
    covered: torch.Tensor    # int32 [..., W] union of selected rows
    coverage: torch.Tensor   # int32 [...] total bits covered
    gains: torch.Tensor      # int32 [..., k] marginal gain at each pick


def resolve_solver(solver: str | None, default: str = "resident") -> str:
    if solver is None:
        solver = default
    if solver not in SOLVERS:
        raise ValueError(
            f"unknown solver {solver!r}; expected one of {SOLVERS}")
    return solver


def greedy_maxcover(rows: torch.Tensor, k: int, solver: str | None = None,
                    excluded=None) -> CoverSolution:
    """Greedy (1 - 1/e)-approximate max-k-cover of rows int32 [n, W] or
    [m, n, W].  ``excluded`` (int32 row ids, [E] or [m, E], -1 pads) are
    never selected — masked exactly like already-picked rows."""
    solver = resolve_solver(solver)
    batched = rows.dim() == 3
    r = rows if batched else rows[None]
    ex = greedy_pick.excluded_ids(excluded, r.shape[0], r.device)
    if solver == "resident":
        out = greedy_pick.greedy_maxcover_resident(r.contiguous(), k, ex)
    elif solver == "lazy":
        out = lazy_greedy.greedy_maxcover_lazy(r.contiguous(), k, ex)[:4]
    elif solver == "fused":
        out = greedy_pick.greedy_plain(r.contiguous(), k, ex,
                                       pick=topk_gain.best_gain_index)
    else:
        out = greedy_pick.greedy_plain(r, k, ex)
    seeds, sel_rows, covered, gains = (o if batched else o[0] for o in out)
    return CoverSolution(seeds, sel_rows, covered,
                         bitset.coverage_size(covered), gains)


def greedy_maxcover_batch(rows: torch.Tensor, excluded, k: int,
                          solver: str | None = None) -> CoverSolution:
    """B seed-constrained queries against one shared pool ``rows`` int32
    [n, W]; ``excluded`` int32 [B, E] (-1 pads).  Every field has a
    leading [B] axis and slice b equals ``greedy_maxcover(rows, k,
    solver, excluded=excluded[b])``.  Only the per-query state fans out:
    the pool is read in place by every solver."""
    solver = resolve_solver(solver)
    n, w = rows.shape
    ex = torch.as_tensor(excluded, dtype=torch.int32).to(rows.device)
    if ex.dim() != 2:
        raise ValueError(f"excluded must be [B, E], got {tuple(ex.shape)}")
    b = ex.shape[0]
    if solver == "resident":
        out = greedy_pick.greedy_maxcover_resident_batch(rows, k, ex)
    elif solver == "lazy":
        out = lazy_greedy.greedy_maxcover_lazy_batch(rows, k, ex)[:4]
    else:
        shared = rows[None].expand(b, n, w)
        if solver == "fused":
            def pick(_, covered, picked):
                return topk_gain.best_gain_index_batch(rows, covered, picked)
            out = greedy_pick.greedy_plain(shared, k, ex.contiguous(),
                                           pick=pick)
        else:
            out = greedy_pick.greedy_plain(shared, k, ex.contiguous())
    seeds, sel_rows, covered, gains = out
    return CoverSolution(seeds, sel_rows, covered,
                         bitset.coverage_size(covered), gains)


def _popcount_words(words) -> int:
    """Host-side popcount of packed words (int32 or uint32 bit patterns)."""
    return sum(bin(int(x)).count("1") for x in
               np.asarray(words).astype(np.uint32).astype(np.uint64).ravel())


def _u64(row) -> np.ndarray:
    return np.asarray(row).astype(np.uint32).astype(np.uint64)


def lazy_greedy_maxcover_np(rows, k: int) -> tuple[list, int]:
    """Paper Algorithm 2 — heap-based lazy greedy (NumPy oracle).
    Returns (seed list, total coverage)."""
    rows = np.asarray(rows)
    n, w = rows.shape
    covered = np.zeros(w, dtype=np.uint64)
    heap = [(-_popcount_words(rows[v]), 0, v) for v in range(n)]
    heapq.heapify(heap)                           # (-gain, stamp, v)
    seeds: list[int] = []
    stamp = 0
    while heap and len(seeds) < k:
        neg_gain, s, v = heapq.heappop(heap)
        fresh = _popcount_words(_u64(rows[v]) & ~covered)
        if -neg_gain == fresh or (heap and fresh >= -heap[0][0]):
            if fresh == 0:
                break
            seeds.append(v)
            covered |= _u64(rows[v])
            stamp += 1
        else:
            heapq.heappush(heap, (-fresh, stamp, v))
    return seeds, _popcount_words(covered)


def coverage_of(rows, seeds) -> int:
    """Coverage of an explicit seed subset (host-side check)."""
    rows = np.asarray(rows)
    covered = np.zeros(rows.shape[1], dtype=np.uint64)
    for s in seeds:
        if s >= 0:
            covered |= _u64(rows[int(s)])
    return _popcount_words(covered)
