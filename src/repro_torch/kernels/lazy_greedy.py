"""Lazy greedy max-k-cover over a machine or query axis
(``csrc/lazy_greedy.cu``) and its plain PyTorch version.

Replaces ``repro/kernels/lazy_greedy.py``: ``greedy_maxcover_lazy_pallas``
(TPU kernel #6) — the resident solve plus a stale upper bound per tile
of ``TILE_ROWS`` rows, so a pick re-sweeps only the tiles whose bound
can still reach the best gain.  The machine axis has the resident
solve's two layouts (``greedy_pick.row_lists``): on the compact one
(``lazy_greedy_compact``, one block a machine) a swept tile costs only
its listed rows' entries, read from L2, and the bounds skip tiles as
before; longer lists (the rows of supercritical cascades) take the
dense sweep (``lazy_greedy``).  Bound on
the H100 of the compact layout: bytes — the rows read once into the
list and the outputs written once.  On the query axis (B queries over
one shared pool, ``repro/kernels/ops.py:83``) each query keeps its own
bounds, and a tile is swept once for a group of G queries
(``greedy_pick.query_groups``): it is skipped only when every query of
the group may skip it, and a sweep refreshes all G bounds.  Seeds,
rows, covered and gains equal the resident solve's bit for bit;
``tiles_swept`` (int32 [m]; on the query axis the sweeps of the query's
group) depends on the order the sweeps run in, lies in [num_tiles, k *
num_tiles] per solve, and is never compared for equality.  Bound of the
dense layout and the query axis: the rows of the tiles an exact
schedule that knows each pick's best sweeps (``lazy_plain``'s
``tiles_needed``; on the query axis the bytes of
``tiles_needed_shared`` against the integer ops of each query's
``tiles_needed`` and ``nonzero_words_needed``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, coverage, greedy_pick, ops

TILE_ROWS = greedy_pick.LIST_TILE_ROWS
# Tiles each block of the machine axis owns at least, so that a pick's
# first phase (every block's largest-bound tile) leaves most tiles to the
# bound test.
MIN_TILES_PER_BLOCK = 8
_UB_INIT = 2**31 - 1
_ARGS = [ops.PTR] * 10 + [ops.I64] * 7
_BATCH_ARGS = [ops.PTR] * 12 + [ops.I64] * 7
_COMPACT_ARGS = [ops.PTR] * 14 + [ops.I64] * 5


def num_row_tiles(n: int) -> int:
    return -(-n // TILE_ROWS)


def lazy_plain(rows: torch.Tensor, k: int, excluded: torch.Tensor,
               stats: dict | None = None, gains=None):
    """``rows`` int32 [m, n, W] (an expanded view of one shared pool
    works and is never copied), excluded int32 [m, E].

    The resident solve's picks, with the reference's in-order bound
    test counting the tiles it would sweep: tile t is swept when its
    bound reaches the best of the tiles before it.  Returns (seeds,
    sel_rows, covered, gains, tiles_swept [m]).

    ``stats["tiles_needed"]`` (int32 [m]) counts the sweeps of an
    exact schedule that knows each pick's final best: every tile in the
    first pick, then in each pick the tiles whose stale bound reaches
    that best (a swept tile's bound becomes its fresh masked max).
    ``stats["tiles_needed_shared"]`` counts the (pick, tile) pairs that
    at least one of the m solves needs: the sweeps of a schedule that
    reads each tile once per pick for all solves, when the m solves
    share one pool (the query axis).  ``stats["nonzero_words_needed"]``
    counts the gain words (row & ~cover) that are not zero in the rows
    of the tiles each solve needs, picked rows left out: the words whose
    popcount such a schedule must take, and
    ``stats["entries_needed"]`` the non-zero row words there, picked rows
    left out: the list entries whose and-not such a schedule must take
    on the compact layout.  ``gains(covered)``, if given,
    computes each pick's [m, n] gains in place of the dense sweep (the
    compact layout's, ``greedy_pick.listed_gains``)."""
    m, n, _ = rows.shape
    tiles = num_row_tiles(n)
    ub = torch.full((m, tiles), _UB_INIT, dtype=torch.int32,
                    device=rows.device)
    ub_need = ub.clone()
    swept = torch.zeros((m,), dtype=torch.int32, device=rows.device)
    needed = torch.zeros_like(swept)
    shared = torch.zeros((), dtype=torch.int64, device=rows.device)
    nonzero = torch.zeros((), dtype=torch.int64, device=rows.device)
    entries = torch.zeros((), dtype=torch.int64, device=rows.device)
    row_words = (torch.stack([(rows[j] != 0).sum(1) for j in range(m)])
                 if stats is not None else None)
    ar = torch.arange(m, device=rows.device)

    def tile_sums(x):
        return torch.nn.functional.pad(x, (0, tiles * TILE_ROWS - n)).reshape(
            m, tiles, TILE_ROWS).sum(2)

    def pick(rows, covered, picked):
        g = torch.where(picked, -1,
                        coverage.marginal_gain_plain(rows, covered)
                        if gains is None else gains(covered))
        tmax = torch.nn.functional.pad(
            g, (0, tiles * TILE_ROWS - n), value=-1).reshape(
                m, tiles, TILE_ROWS).amax(2)
        before = torch.nn.functional.pad(
            torch.cummax(tmax, dim=1).values[:, :-1], (1, 0), value=-1)
        go = ub >= before
        ub.copy_(torch.where(go, tmax, ub))
        swept.add_(go.sum(1, dtype=torch.int32))
        best = torch.argmax(g, dim=1)
        need = ub_need >= g[ar, best][:, None]
        ub_need.copy_(torch.where(need, tmax, ub_need))
        needed.add_(need.sum(1, dtype=torch.int32))
        shared.add_(need.any(0).sum())
        if stats is not None:
            nz = torch.stack([((rows[j] & ~covered[j]) != 0).sum(1)
                              for j in range(m)])
            nonzero.add_((tile_sums(torch.where(picked, 0, nz)) * need).sum())
            entries.add_((tile_sums(torch.where(picked, 0, row_words))
                          * need).sum())
        return g[ar, best], best

    out = greedy_pick.greedy_plain(rows, k, excluded, pick=pick)
    if stats is not None:
        stats["tiles_needed"] = needed
        stats["tiles_needed_shared"] = int(shared)
        stats["nonzero_words_needed"] = int(nonzero)
        stats["entries_needed"] = int(entries)
    return (*out, swept)


def blocks_per_machine(m: int, n: int, num_words: int, device) -> int:
    """The kernel's blocks per machine at this shape on the CUDA
    ``device``: the tiles of a machine that every pick's first phase
    sweeps."""
    with torch.cuda.device(device):
        bpm = int(build.function(
            "lazy_greedy", "lazy_greedy_blocks_per_machine", [ops.I64] * 5)(
                m, n, num_words, TILE_ROWS, MIN_TILES_PER_BLOCK))
    if bpm <= 0:
        raise ValueError(f"lazy_greedy: no launch at m={m}, n={n}, "
                         f"W={num_words} (code {bpm})")
    return bpm


def lazy_compact_plain(rows: torch.Tensor, k: int, excluded: torch.Tensor,
                       lists: greedy_pick.RowLists):
    """The compact layout's lazy solve in plain PyTorch: :func:`lazy_plain`
    with each pick's gains swept from ``lists``."""
    return lazy_plain(rows, k, excluded,
                      gains=greedy_pick.listed_gains(lists))


def _launch(counter: str, fn: str, argtypes, rows: torch.Tensor, m: int,
            n: int, w: int, k: int, ex: torch.Tensor, extra=(), tail=()):
    """Outputs (seeds, sel_rows, covered, gains, tiles_swept) of m solves
    from one launch of ``fn``; ``extra`` tensors go after the tile
    bounds, ``tail`` integers after the tile size."""
    dev = rows.device
    out = greedy_pick.outputs(m, k, w, dev)
    swept = torch.zeros((m,), dtype=torch.int32, device=dev)
    if m * n * k == 0:
        return (*out, swept)
    keys = torch.zeros((m, k), dtype=torch.int64, device=dev)
    taken = torch.zeros((m, n), dtype=torch.uint8, device=dev)
    ub = torch.full((m, num_row_tiles(n)), _UB_INIT, dtype=torch.int32,
                    device=dev)
    ops.launch(counter, "lazy_greedy", fn, argtypes,
               rows.data_ptr(), ex.data_ptr(), keys.data_ptr(),
               taken.data_ptr(), ub.data_ptr(),
               *(t.data_ptr() for t in extra), swept.data_ptr(),
               *(o.data_ptr() for o in out), m, n, w, k, ex.shape[1],
               TILE_ROWS, *tail)
    return (*out, swept)


def lazy_dense(rows: torch.Tensor, k: int, ex: torch.Tensor):
    """The dense layout: each pick sweeps the rows of the tiles its
    bounds keep (``lazy_greedy``); ``ex`` from
    ``greedy_pick.excluded_ids``."""
    m, n, w = rows.shape
    if not ops.on_card(rows, ex):
        return lazy_plain(rows, k, ex)
    ops.check(rows, "rows", torch.int32, (m, n, w))
    return _launch("lazy_greedy", "lazy_greedy", _ARGS, rows, m, n, w, k, ex,
                   tail=(MIN_TILES_PER_BLOCK,))


def lazy_compact(rows: torch.Tensor, k: int, ex: torch.Tensor,
                 lists: greedy_pick.RowLists):
    """The compact layout: each pick sweeps the listed rows of the tiles
    its bounds keep (``lazy_greedy_compact``, one block a machine)."""
    m, n, w = rows.shape
    if not ops.on_card(rows, ex, lists.entries):
        return lazy_compact_plain(rows, k, ex, lists)
    ops.check(rows, "rows", torch.int32, (m, n, w))
    dev = rows.device
    out = greedy_pick.outputs(m, k, w, dev)
    swept = torch.zeros((m,), dtype=torch.int32, device=dev)
    if m * n * k == 0:
        return (*out, swept)
    taken = torch.zeros((m, n), dtype=torch.uint8, device=dev)
    ub = torch.full((m, num_row_tiles(n)), _UB_INIT, dtype=torch.int32,
                    device=dev)
    ops.launch("lazy_greedy_compact", "lazy_greedy", "lazy_greedy_compact",
               _COMPACT_ARGS, rows.data_ptr(), ex.data_ptr(),
               lists.row_ids.data_ptr(), lists.counts.data_ptr(),
               lists.starts.data_ptr(), lists.tiles.data_ptr(),
               lists.entries.data_ptr(), taken.data_ptr(), ub.data_ptr(),
               swept.data_ptr(), *(o.data_ptr() for o in out), m, n, w, k,
               ex.shape[1])
    return (*out, swept)


def greedy_maxcover_lazy(rows: torch.Tensor, k: int, excluded=None,
                         stats: dict | None = None):
    """All k picks of every machine of ``rows`` int32 [m, n, W] ->
    (seeds, sel_rows, covered, gains, tiles_swept): the list
    (``greedy_pick.row_lists``), then one launch of the layout it chose;
    ``excluded`` int32 [E] or [m, E] row ids are never picked.
    ``stats`` gets the layout, the non-zero words and the listed rows."""
    m, n, w = rows.shape
    ex = greedy_pick.excluded_ids(excluded, m, rows.device)
    ops.on_card(rows, ex)                  # raises on mixed devices
    if m * n * k == 0:
        return (*greedy_pick.outputs(m, k, w, rows.device),
                torch.zeros((m,), dtype=torch.int32, device=rows.device))
    lists = greedy_pick.row_lists(rows)
    greedy_pick.report(stats, lists)
    if lists.entries is None:
        return lazy_dense(rows, k, ex)
    return lazy_compact(rows, k, ex, lists)


def greedy_maxcover_lazy_batch(rows: torch.Tensor, k: int,
                               excluded: torch.Tensor):
    """B seed-constrained queries over one shared pool ``rows`` int32
    [n, W] in one launch -> (seeds, sel_rows, covered, gains,
    tiles_swept), each with a leading [B] axis; ``excluded`` int32
    [B, E].  The pool is read in place, never copied per query."""
    n, w = rows.shape
    if excluded.dim() != 2:
        raise ValueError(f"excluded must be [B, E], got {tuple(excluded.shape)}")
    b = excluded.shape[0]
    ex = greedy_pick.excluded_ids(excluded, b, rows.device)
    if not ops.on_card(rows, ex):
        return lazy_plain(rows[None].expand(b, n, w), k, ex)
    ops.check(rows, "rows", torch.int32, (n, w))
    g, groups = greedy_pick.query_plan("lazy_greedy", b, w, rows.device)
    # each pick's largest bound per query over all tiles, and the
    # shortlists of tiles to sweep (lazy_greedy.cu)
    ub_top = torch.full((b, k), -2**31, dtype=torch.int32, device=rows.device)
    work = torch.zeros((groups * k + 3 * num_row_tiles(n),), dtype=torch.int32,
                       device=rows.device)
    return _launch("lazy_greedy_batch", "lazy_greedy_batch", _BATCH_ARGS,
                   rows, b, n, w, k, ex, extra=(ub_top, work), tail=(g,))
