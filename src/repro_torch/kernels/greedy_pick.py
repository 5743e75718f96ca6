"""Greedy max-k-cover over a machine or query axis
(``csrc/greedy_pick.cu``) and its plain PyTorch version (the scan
solver).

Replaces ``repro/kernels/greedy_pick.py``: ``greedy_maxcover_resident_pallas``
(TPU kernel #3), which the reference vmaps over the m machines and, for
serving, over B queries sharing one row pool
(``repro/kernels/ops.py:68``); here either axis is one launch.  Each
pick masks picked and excluded rows to gain -1, takes the largest gain
with the lowest-index tie-break, and commits as ``commit_pick``: a best
gain <= 0 gives seed -1, gain 0 and a zero row.

The machine axis has two layouts.  The incidence rows of subcritical
cascades are almost all zero words, so :func:`row_lists` first reads
the rows once into a list of their non-zero words (``compact_rows``,
:class:`RowLists`), and while the list is short enough
(:func:`compact_pays`) every pick sweeps the list alone
(``greedy_pick_compact``, one block a machine).  Bound on the H100:
bytes — the rows read once and the outputs written once; the picks are
latency, not traffic.  The rows of supercritical cascades are nearly
all non-zero words, and a longer list takes the dense sweep
(``greedy_pick``), which re-reads every row in each pick over all SMs.
Both layouts give the same bits; ``ops.LAUNCHES`` and
``stats["layout"]`` show which one ran.  The query
axis reads the shared pool in place, never copied: blocks own rows, and
each row is read once per pick for a group of G queries whose covers
sit in shared memory (:func:`query_groups`), so a pick moves ceil(B /
G) pools, not B (bound: the tiles an exact lazy schedule needs, read
once for all the queries that need them).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bitset
from repro_torch.kernels import build, ops, topk_gain

_ARGS = [ops.PTR] * 8 + [ops.I64] * 5
_BATCH_ARGS = [ops.PTR] * 8 + [ops.I64] * 6
_COMPACT_ARGS = [ops.PTR] * 8 + [ops.I64] * 4
_COMPACT_PICK_ARGS = [ops.PTR] * 12 + [ops.I64] * 5
# The largest query group the query-axis kernels are built for
# (``kMaxGroup`` in ``csrc/greedy_core.cuh``).
MAX_GROUP = 8
# ``kTileRows`` in ``csrc/greedy_core.cuh``: the list keeps the rows of
# each tile of this many rows together (a warp lane a row), the lazy
# solve's tiles.
LIST_TILE_ROWS = 32
# The layout rule (:func:`compact_pays`), set from both layouts forced on
# rows with 0.01% to 50% of their words non-zero at m = 2, 8 and 32
# (``tools/time_solves.py --axis sweep``, NVIDIA H100 80GB HBM3, 700 W).
# The compact picks run on one block a machine, where an entry costs
# 0.45-1.3 ns (a row of more than four entries takes the whole warp, one
# row at a time), and the list mostly misses L2 once it is long; the
# dense sweep streams every word over all SMs at about 1.3 ps a word.  So
# the compact layout pays while the list holds at most
# m' x (words / COMPACT_WORDS_PER_ENTRY + COMPACT_BLOCK_ENTRIES) entries,
# m' = min(m, COMPACT_MAX_MACHINES): a block's share of the list then
# costs it no more than the dense sweep costs the card, the second term
# standing for the dense sweep's grid-wide syncs in each pick.  m' stops
# at 16: at m = 32 the lazy solves crossed below m / 1024 of the words.
COMPACT_WORDS_PER_ENTRY = 1024
COMPACT_BLOCK_ENTRIES = 1024
COMPACT_MAX_MACHINES = 16


class RowLists(NamedTuple):
    """The compact layout of rows int32 [m, n, W]
    (``csrc/greedy_core.cuh``).  Machine j's slots 0 .. listed[j] - 1
    name its rows that hold a non-zero word, the slots of one
    ``LIST_TILE_ROWS``-row tile together (``tiles``); a row's entries
    are contiguous, in word order.  ``entries`` is None when the dense
    sweep pays (:func:`compact_pays`): the list was not written whole."""
    listed: torch.Tensor       # int32 [m] rows listed per machine
    row_ids: torch.Tensor      # int32 [m, n] slot -> row
    counts: torch.Tensor       # int32 [m, n] slot -> its row's entries
    starts: torch.Tensor       # int64 [m, n] slot -> its row's first entry
    tiles: torch.Tensor        # int32 [m, tiles, 2] first slot, slots
    entries: torch.Tensor | None  # int32 [nonzero_words, 2] index, word
    nonzero_words: int


def compact_capacity(words: int, m: int) -> int:
    """The longest list of ``words`` dense words over ``m`` machines on
    which the compact layout pays (the constants above)."""
    return min(m, COMPACT_MAX_MACHINES) * (
        words // COMPACT_WORDS_PER_ENTRY + COMPACT_BLOCK_ENTRIES)


def compact_pays(entries: int, words: int, m: int) -> bool:
    """The compact layout pays for a list of ``entries`` non-zero words of
    ``words`` dense words over ``m`` machines."""
    return entries <= compact_capacity(words, m)


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


def _segments(starts: torch.Tensor, counts: torch.Tensor):
    """(segment, position) of every entry of the runs [starts[i],
    starts[i] + counts[i]), in the runs' order: int64 each."""
    counts = counts.long()
    seg = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)
    first = torch.cumsum(counts, 0) - counts
    pos = starts[seg] + torch.arange(seg.numel(), device=counts.device) \
        - first[seg]
    return seg, pos


def _listed_slots(lists: RowLists):
    """(machine, row, count, start) of every listed slot."""
    m, n = lists.row_ids.shape
    dev = lists.row_ids.device
    valid = torch.arange(n, device=dev)[None] < lists.listed[:, None]
    mach = torch.arange(m, device=dev)[:, None].expand(m, n)[valid]
    return (mach, lists.row_ids[valid].long(), lists.counts[valid],
            lists.starts[valid])


def compact_rows_plain(rows: torch.Tensor) -> RowLists:
    """The compact layout of rows int32 [m, n, W] in plain PyTorch, in
    the canonical order: each machine's listed rows ascending, entries
    machine by machine and row by row (the kernel's order is free)."""
    m, n, w = rows.shape
    nz = rows != 0
    per_row = nz.sum(2, dtype=torch.int32)
    has = per_row > 0
    order = torch.argsort((~has).to(torch.int8), dim=1, stable=True)
    flat = per_row.reshape(-1).long()
    starts = (torch.cumsum(flat, 0) - flat).reshape(m, n)
    j, r, i = nz.nonzero(as_tuple=True)
    tiles = -(-n // LIST_TILE_ROWS)
    per_tile = torch.nn.functional.pad(has, (0, tiles * LIST_TILE_ROWS - n)
                                       ).reshape(m, tiles, LIST_TILE_ROWS
                                                 ).sum(2, dtype=torch.int32)
    first = torch.cumsum(per_tile, 1, dtype=torch.int32) - per_tile
    return RowLists(
        has.sum(1, dtype=torch.int32), order.to(torch.int32),
        per_row.gather(1, order), starts.gather(1, order),
        torch.stack([first, per_tile], 2),
        torch.stack([i.to(torch.int32), rows[j, r, i]], 1), int(j.numel()))


def canonical_lists(lists: RowLists):
    """A list in :func:`compact_rows_plain`'s order, to compare two
    lists as sets of rows each with its entries: (listed, machine and
    row of each slot, their counts, the entries, slots per tile).
    Raises unless the tile table holds every slot in its row's tile."""
    m, n = lists.row_ids.shape
    mach, row, count, start = _listed_slots(lists)
    first, per = lists.tiles[..., 0].long(), lists.tiles[..., 1].long()
    tile = row // LIST_TILE_ROWS
    slot = torch.nonzero(torch.arange(n, device=row.device)[None]
                         < lists.listed[:, None], as_tuple=True)[1]
    at = first[mach, tile]
    in_tile = torch.bincount(mach * per.shape[1] + tile,
                             minlength=per.numel()).reshape(per.shape)
    if not (bool(((at <= slot) & (slot < at + per[mach, tile])).all())
            and torch.equal(in_tile, per)):
        raise AssertionError("the tile table does not hold the slots of "
                             "its tiles")
    order = torch.argsort(mach * n + row)
    _, pos = _segments(start[order], count[order])
    return (lists.listed, mach[order], row[order], count[order],
            lists.entries[pos], lists.tiles[..., 1])


def listed_gains(lists: RowLists):
    """``gains(covered int32 [m, W]) -> int32 [m, n]``: each row's gain
    swept from its entries in ``lists`` alone (unlisted rows gain 0)."""
    m, n = lists.row_ids.shape
    mach, row, count, start = _listed_slots(lists)
    seg, pos = _segments(start, count)
    flat = torch.empty_like(pos)
    flat[pos] = mach[seg] * n + row[seg]
    owner = flat // n
    idx = lists.entries[:, 0].long()
    word = lists.entries[:, 1]

    def gains(covered: torch.Tensor) -> torch.Tensor:
        g = torch.zeros(m * n, dtype=torch.int32, device=covered.device)
        g.index_add_(0, flat, bitset.popcount(word & ~covered[owner, idx]))
        return g.view(m, n)
    return gains


def greedy_compact_plain(rows: torch.Tensor, k: int, excluded: torch.Tensor,
                         lists: RowLists):
    """The compact layout's solve in plain PyTorch: :func:`greedy_plain`
    with each pick's gains swept from ``lists``."""
    gains = listed_gains(lists)
    return greedy_plain(rows, k, excluded, pick=lambda rows, covered, picked:
                        topk_gain.best_of(gains(covered), picked))


def compact_rows_launch(rows: torch.Tensor, cap: int):
    """One launch of ``compact_rows`` over rows int32 [m, n, W] on the
    card into ``cap`` entries -> (the list, its ``nonzero_words`` not
    read yet, and the int64 [1] count on the card, which also counts the
    entries past ``cap``; those are not written)."""
    m, n, w = rows.shape
    dev = rows.device
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    listed = torch.zeros(m, dtype=torch.int32, device=dev)
    row_ids = torch.empty((m, n), dtype=torch.int32, device=dev)
    counts = torch.empty((m, n), dtype=torch.int32, device=dev)
    starts = torch.empty((m, n), dtype=torch.int64, device=dev)
    tiles = torch.empty((m, -(-n // LIST_TILE_ROWS), 2), dtype=torch.int32,
                        device=dev)
    entries = torch.empty((cap, 2), dtype=torch.int32, device=dev)
    ops.launch("compact_rows", "greedy_pick", "compact_rows", _COMPACT_ARGS,
               rows.data_ptr(), total.data_ptr(), listed.data_ptr(),
               row_ids.data_ptr(), counts.data_ptr(), starts.data_ptr(),
               tiles.data_ptr(), entries.data_ptr(), m, n, w, cap)
    return RowLists(listed, row_ids, counts, starts, tiles, entries,
                    -1), total


def compact_rows(rows: torch.Tensor, cap: int) -> RowLists:
    """:func:`compact_rows_launch` with its count read back to the host
    (8 bytes)."""
    lists, total = compact_rows_launch(rows, cap)
    return lists._replace(nonzero_words=int(total))


def row_lists(rows: torch.Tensor) -> RowLists:
    """The compact layout of rows int32 [m, n, W] (m, n >= 1): one
    ``compact_rows`` launch on the card into room for the longest list
    the compact layout takes (:func:`compact_capacity`), its plain
    version on the CPU; ``entries`` None when the count passes that
    (the dense sweep pays)."""
    m, n, w = rows.shape
    words = m * n * w
    if not ops.on_card(rows):
        lists = compact_rows_plain(rows)
    else:
        ops.check(rows, "rows", torch.int32, (m, n, w))
        lists = compact_rows(rows, min(compact_capacity(words, m), words))
    if not compact_pays(lists.nonzero_words, words, m):
        return lists._replace(entries=None)
    return lists._replace(entries=lists.entries[:lists.nonzero_words])


def report(stats: dict | None, lists: RowLists) -> None:
    """The layout that runs, the non-zero words and the listed rows, into
    ``stats`` when given (one host read of the listed rows)."""
    if stats is not None:
        stats.update(layout="dense" if lists.entries is None else "compact",
                     nonzero_words=lists.nonzero_words,
                     listed_rows=int(lists.listed.sum()))


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


def outputs(m: int, k: int, w: int, device):
    """(seeds, sel_rows, covered, gains) before any pick: seeds -1, the
    rest zero."""
    return (torch.full((m, k), -1, dtype=torch.int32, device=device),
            torch.zeros((m, k, w), dtype=torch.int32, device=device),
            torch.zeros((m, w), dtype=torch.int32, device=device),
            torch.zeros((m, k), dtype=torch.int32, device=device))


def _launch(counter: str, fn: str, argtypes, rows: torch.Tensor, m: int,
            n: int, w: int, k: int, ex: torch.Tensor, *tail: int):
    out = outputs(m, k, w, rows.device)
    if m * n * k == 0:
        return out
    keys = torch.zeros((m, k), dtype=torch.int64, device=rows.device)
    taken = torch.zeros((m, n), dtype=torch.uint8, device=rows.device)
    ops.launch(counter, "greedy_pick", fn, argtypes, rows.data_ptr(),
               ex.data_ptr(), keys.data_ptr(), taken.data_ptr(),
               *(o.data_ptr() for o in out), m, n, w, k, ex.shape[1], *tail)
    return out


def greedy_dense(rows: torch.Tensor, k: int, ex: torch.Tensor):
    """The dense layout: every pick sweeps every row of ``rows`` int32
    [m, n, W] (``greedy_pick``); ``ex`` from :func:`excluded_ids`."""
    m, n, w = rows.shape
    if not ops.on_card(rows, ex):
        return greedy_plain(rows, k, ex)
    ops.check(rows, "rows", torch.int32, (m, n, w))
    return _launch("greedy_pick", "greedy_pick", _ARGS, rows, m, n, w, k, ex)


def greedy_compact(rows: torch.Tensor, k: int, ex: torch.Tensor,
                   lists: RowLists):
    """The compact layout: every pick sweeps ``lists`` (from
    :func:`row_lists`, entries not None) and commits from ``rows``
    (``greedy_pick_compact``, one block a machine)."""
    m, n, w = rows.shape
    if not ops.on_card(rows, ex, lists.entries):
        return greedy_compact_plain(rows, k, ex, lists)
    ops.check(rows, "rows", torch.int32, (m, n, w))
    out = outputs(m, k, w, rows.device)
    if m * n * k == 0:
        return out
    taken = torch.zeros((m, n), dtype=torch.uint8, device=rows.device)
    ops.launch("greedy_pick_compact", "greedy_pick", "greedy_pick_compact",
               _COMPACT_PICK_ARGS, rows.data_ptr(), ex.data_ptr(),
               lists.listed.data_ptr(), lists.row_ids.data_ptr(),
               lists.counts.data_ptr(), lists.starts.data_ptr(),
               lists.entries.data_ptr(), taken.data_ptr(),
               *(o.data_ptr() for o in out), m, n, w, k, ex.shape[1])
    return out


def greedy_maxcover_resident(rows: torch.Tensor, k: int, excluded=None,
                             stats: dict | None = None):
    """All k picks of every machine of ``rows`` int32 [m, n, W]: the
    list (:func:`row_lists`), then one launch of the layout it chose;
    ``excluded`` int32 [E] or [m, E] row ids never picked.  ``stats``
    gets the layout, the non-zero words and the listed rows."""
    m, n, w = rows.shape
    ex = excluded_ids(excluded, m, rows.device)
    ops.on_card(rows, ex)                  # raises on mixed devices
    if m * n * k == 0:
        return outputs(m, k, w, rows.device)
    lists = row_lists(rows)
    report(stats, lists)
    if lists.entries is None:
        return greedy_dense(rows, k, ex)
    return greedy_compact(rows, k, ex, lists)


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
