"""Greedy max-k-cover over a machine or query axis
(``csrc/greedy_pick.cu``) and its plain PyTorch version (the scan
solver).

Replaces ``repro/kernels/greedy_pick.py``: ``greedy_maxcover_resident_pallas``
(TPU kernel #3), which the reference vmaps over the m machines and, for
serving, over B queries sharing one row pool
(``repro/kernels/ops.py:68``); here either axis is one cooperative
launch.  Each pick masks picked and excluded rows to gain -1, takes the
largest gain with the lowest-index tie-break, and commits as
``commit_pick``: a best gain <= 0 gives seed -1, gain 0 and a zero row.

The machine axis gives each machine its share of the blocks (bound on
the H100: bytes — the rows an exact lazy schedule must sweep,
``lazy_plain``'s ``tiles_needed``; the kernel re-reads every row each
pick).  The query axis reads the shared pool in place, never copied:
blocks own rows, and each row is read once per pick for a group of G
queries whose covers sit in shared memory (:func:`query_groups`), so a
pick moves ceil(B / G) pools, not B (bound: as the machine axis's,
the tiles read once for all the queries that need them).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ops, topk_gain

_ARGS = [ops.PTR] * 8 + [ops.I64] * 5
_BATCH_ARGS = [ops.PTR] * 8 + [ops.I64] * 6
# The largest query group the query-axis kernels are built for
# (``kMaxGroup`` in ``csrc/greedy_core.cuh``).
MAX_GROUP = 8


def excluded_ids(excluded, m: int, device) -> torch.Tensor:
    """int32 [m, E] exclusion ids (-1 pads); one row is shared by all
    machines when a flat [E] array is given."""
    if excluded is None:
        excluded = torch.full((1,), -1, dtype=torch.int32)
    ex = torch.as_tensor(excluded, dtype=torch.int32).to(device)
    if ex.dim() == 1:
        ex = ex[None].expand(m, -1)
    if ex.dim() != 2 or ex.shape[0] != m:
        raise ValueError(f"excluded must be [E] or [{m}, E], got "
                         f"{tuple(ex.shape)}")
    return ex.contiguous()


def greedy_plain(rows: torch.Tensor, k: int, excluded: torch.Tensor,
                 pick=topk_gain.best_gain_index_plain):
    """rows int32 [m, n, W] (an expanded view of one shared pool works
    and is never copied), excluded int32 [m, E] -> (seeds [m, k],
    sel_rows [m, k, W], covered [m, W], gains [m, k]): k calls of
    ``pick(rows, covered, picked) -> (best gain, best index)`` (the
    plain sweep by default, ``topk_gain.best_gain_index`` for the fused
    solver), each committed on the device as the reference's loop body —
    no host sync per pick."""
    m, n, w = rows.shape
    dev = rows.device
    covered = torch.zeros((m, w), dtype=torch.int32, device=dev)
    seeds = torch.full((m, k), -1, dtype=torch.int32, device=dev)
    sel_rows = torch.zeros((m, k, w), dtype=torch.int32, device=dev)
    gains = torch.zeros((m, k), dtype=torch.int32, device=dev)
    if n == 0:
        return seeds, sel_rows, covered, gains
    picked = torch.zeros((m, n), dtype=torch.bool, device=dev)
    ok = (excluded >= 0) & (excluded < n)
    mach = torch.arange(m, device=dev)[:, None].expand_as(excluded)
    picked[mach[ok], excluded[ok].long()] = True
    ar = torch.arange(m, device=dev)
    for i in range(k):
        best_gain, best = pick(rows, covered, picked)
        best = best.long()
        take = best_gain > 0
        row = torch.where(take[:, None], rows[ar, best], 0)
        covered |= row
        seeds[:, i] = torch.where(take, best.to(torch.int32), -1)
        sel_rows[:, i] = row
        gains[:, i] = torch.where(take, best_gain, 0)
        picked[ar, best] |= take
    return seeds, sel_rows, covered, gains


def query_groups(b: int, num_words: int, budget: int) -> tuple[int, int]:
    """(G, groups) for B queries of ``num_words``-word covers when a block
    may give ``budget`` bytes of shared memory to covers: G is as many
    queries as the budget and :data:`MAX_GROUP` allow, at most B, and
    the last group holds the rest (12 queries go 8 + 4).  A cover wider
    than the budget still gets G = 1, and the kernel refuses it."""
    if b < 1:
        raise ValueError(f"need at least one query, got {b}")
    g = max(1, min(MAX_GROUP, b, budget // (4 * num_words)))
    return g, -(-b // g)


def query_plan(lib: str, b: int, num_words: int, device) -> tuple[int, int]:
    """:func:`query_groups` with the shared-memory budget of ``lib``'s
    query-axis kernel on the CUDA ``device``."""
    with torch.cuda.device(device):
        budget = int(build.function(lib, f"{lib}_batch_budget", [])())
    if budget <= 0:
        raise RuntimeError(f"{lib}: CUDA error {-budget} reading the "
                           "shared-memory budget")
    return query_groups(b, num_words, budget)


def _launch(counter: str, fn: str, argtypes, rows: torch.Tensor, m: int,
            n: int, w: int, k: int, ex: torch.Tensor, *tail: int):
    dev = rows.device
    seeds = torch.full((m, k), -1, dtype=torch.int32, device=dev)
    sel_rows = torch.zeros((m, k, w), dtype=torch.int32, device=dev)
    covered = torch.zeros((m, w), dtype=torch.int32, device=dev)
    gains = torch.zeros((m, k), dtype=torch.int32, device=dev)
    if m * n * k == 0:
        return seeds, sel_rows, covered, gains
    keys = torch.zeros((m, k), dtype=torch.int64, device=dev)
    taken = torch.zeros((m, n), dtype=torch.uint8, device=dev)
    ops.launch(counter, "greedy_pick", fn, argtypes,
               rows.data_ptr(), ex.data_ptr(), keys.data_ptr(), taken.data_ptr(),
               seeds.data_ptr(), sel_rows.data_ptr(), covered.data_ptr(),
               gains.data_ptr(), m, n, w, k, ex.shape[1], *tail)
    return seeds, sel_rows, covered, gains


def greedy_maxcover_resident(rows: torch.Tensor, k: int, excluded=None):
    """All k picks of every machine of ``rows`` int32 [m, n, W] in one
    launch; ``excluded`` int32 [E] or [m, E] row ids never picked."""
    m, n, w = rows.shape
    ex = excluded_ids(excluded, m, rows.device)
    if not ops.on_card(rows, ex):
        return greedy_plain(rows, k, ex)
    ops.check(rows, "rows", torch.int32, (m, n, w))
    return _launch("greedy_pick", "greedy_pick", _ARGS, rows, m, n, w, k, ex)


def greedy_maxcover_resident_batch(rows: torch.Tensor, k: int,
                                   excluded: torch.Tensor):
    """B seed-constrained queries over one shared pool ``rows`` int32
    [n, W], all k picks of every query in one launch; ``excluded`` int32
    [B, E] (-1 pads).  The pool is read in place, never copied per
    query, once per pick for each group of queries; slice b equals the
    solve of query b alone."""
    n, w = rows.shape
    if excluded.dim() != 2:
        raise ValueError(f"excluded must be [B, E], got {tuple(excluded.shape)}")
    b = excluded.shape[0]
    ex = excluded_ids(excluded, b, rows.device)
    if not ops.on_card(rows, ex):
        return greedy_plain(rows[None].expand(b, n, w), k, ex)
    ops.check(rows, "rows", torch.int32, (n, w))
    g, _ = query_plan("greedy_pick", b, w, rows.device)
    return _launch("greedy_pick_batch", "greedy_pick_batch", _BATCH_ARGS,
                   rows, b, n, w, k, ex, g)
