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
dense sweep (``lazy_greedy``), which hands over to the compact picks,
its tile bounds carried along, once the residual fits
(:func:`lazy_dense`).  Bound on
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

# The contract checker's declaration (``repro_torch/analysis/contracts.py``):
# a lazy solve's launches on either layout, and the query axis's one.
CONTRACT = dict(
    family="lazy_greedy",
    dtypes=("bool", "int8", "int32", "int64", "uint8"),
    variants=dict(
        resident=dict(launches={"compact_rows": 1, "lazy_greedy_compact": 1}),
        dense=dict(launches={"lazy_greedy": 1, "compact_rows": 1,
                             "lazy_greedy_compact": 1}),
        # G >= 2 queries' gains and keys spill from the 128 registers
        # a thread of 512 may hold (32-112 bytes a thread)
        batch=dict(launches={"lazy_greedy_batch": 1},
                   local_memory=("lazy_greedy_batch",)),
    ),
)

TILE_ROWS = greedy_pick.LIST_TILE_ROWS
# Tiles each block of the machine axis owns at least, so that a pick's
# first phase (every block's largest-bound tile) leaves most tiles to the
# bound test.
MIN_TILES_PER_BLOCK = 8
_UB_INIT = 2**31 - 1
_ARGS = [ops.PTR] * 12 + [ops.I64] * 8
_BATCH_ARGS = [ops.PTR] * 12 + [ops.I64] * 7
_COMPACT_ARGS = [ops.PTR] * 14 + [ops.I64] * 6


def num_row_tiles(n: int) -> int:
    return -(-n // TILE_ROWS)


def _tile_sums(x: torch.Tensor, tiles: int) -> torch.Tensor:
    """[m, n] -> [m, tiles]: the sums over each ``TILE_ROWS``-row tile."""
    m, n = x.shape
    return torch.nn.functional.pad(x, (0, tiles * TILE_ROWS - n)).reshape(
        m, tiles, TILE_ROWS).sum(2)


def _sweep_test(ub: torch.Tensor, g: torch.Tensor):
    """The reference's in-order bound test of one pick over its masked
    gains ``g`` [m, n]: (each tile's fresh masked max, the tiles swept) —
    a tile is swept when its bound ``ub`` reaches the best of the tiles
    before it."""
    m, n = g.shape
    tiles = ub.shape[1]
    tmax = torch.nn.functional.pad(
        g, (0, tiles * TILE_ROWS - n), value=-1).reshape(
            m, tiles, TILE_ROWS).amax(2)
    before = torch.nn.functional.pad(
        torch.cummax(tmax, dim=1).values[:, :-1], (1, 0), value=-1)
    return tmax, ub >= before


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
    ub, swept = fresh_bounds(m, n, rows.device)
    ub_need = ub.clone()
    needed = torch.zeros_like(swept)
    shared = torch.zeros((), dtype=torch.int64, device=rows.device)
    nonzero = torch.zeros((), dtype=torch.int64, device=rows.device)
    entries = torch.zeros((), dtype=torch.int64, device=rows.device)
    row_words = (torch.stack([(rows[j] != 0).sum(1) for j in range(m)])
                 if stats is not None else None)
    ar = torch.arange(m, device=rows.device)

    def pick(rows, covered, picked):
        g = torch.where(picked, -1,
                        coverage.marginal_gain_plain(rows, covered)
                        if gains is None else gains(covered))
        tmax, go = _sweep_test(ub, g)
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
            nonzero.add_((_tile_sums(torch.where(picked, 0, nz), tiles)
                          * need).sum())
            entries.add_((_tile_sums(torch.where(picked, 0, row_words), tiles)
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


def lazy_picks_plain(rows: torch.Tensor, k: int,
                     state: greedy_pick.Partial, ub: torch.Tensor,
                     swept: torch.Tensor, cap: int = 0, gains=None):
    """The lazy kernels' picks from ``state`` in plain PyTorch: the dense
    sweep's (``lazy_greedy``) or, with ``gains(covered)`` (the compact
    layout's, ``greedy_pick.listed_gains``), the compact picks', with the
    reference's in-order bound test on ``ub`` [m, tiles] and ``swept``
    [m] (both updated in place), stopping where the gains run out.  The
    dense picks count a tile's residual when they sweep it (a count that
    bounds it until the next sweep: the cover and the taken rows only
    grow; every tile is swept in the first pick) and hand over after the
    first pick whose sum over all tiles is at most ``cap`` (0: never).
    Returns the :class:`greedy_pick.Partial` after the picks."""
    ar = torch.arange(rows.shape[0], device=rows.device)
    counted = gains is None
    tile_resid = torch.zeros_like(ub, dtype=torch.int64)

    def pick(rows, covered, picked):
        g = torch.where(picked, -1,
                        coverage.marginal_gain_plain(rows, covered)
                        if gains is None else gains(covered))
        tmax, go = _sweep_test(ub, g)
        ub.copy_(torch.where(go, tmax, ub))
        swept.add_(go.sum(1, dtype=torch.int32))
        if counted:
            nz = ((rows & ~covered[:, None, :]) != 0).sum(2)
            tile_resid.copy_(torch.where(go, _tile_sums(
                torch.where(picked, 0, nz), ub.shape[1]), tile_resid))
        best = torch.argmax(g, dim=1)
        return g[ar, best], best

    return greedy_pick.plain_picks(
        rows, k, state, pick, cap,
        (lambda covered, taken: tile_resid.sum()) if counted else None,
        stop=True)


def fresh_bounds(m: int, n: int, device):
    """(ub int32 [m, tiles] at INT32_MAX, tiles_swept int32 [m] at 0):
    the lazy state of a fresh solve."""
    return (torch.full((m, num_row_tiles(n)), _UB_INIT, dtype=torch.int32,
                       device=device),
            torch.zeros((m,), dtype=torch.int32, device=device))


def lazy_dense_plain(rows: torch.Tensor, k: int, excluded: torch.Tensor,
                     cap: int = 0):
    """The dense lazy kernel's picks (``lazy_greedy``) in plain PyTorch
    from pick 0 (:func:`lazy_picks_plain`) -> (the
    :class:`greedy_pick.Partial`, the tile bounds, tiles_swept)."""
    m, n, _ = rows.shape
    ub, swept = fresh_bounds(m, n, rows.device)
    state = lazy_picks_plain(rows, k, greedy_pick.start(rows, k, excluded),
                             ub, swept, cap)
    return state, ub, swept


def lazy_compact_plain(rows: torch.Tensor, k: int, excluded: torch.Tensor,
                       lists: greedy_pick.RowLists,
                       state: greedy_pick.Partial | None = None,
                       ub: torch.Tensor | None = None,
                       swept: torch.Tensor | None = None):
    """The compact layout's lazy solve in plain PyTorch, each pick's gains
    swept from ``lists``: from pick 0, :func:`lazy_plain`'s schedule; from
    a dense solve's ``state``, its bounds ``ub`` and ``swept`` (over the
    list of its residual), :func:`lazy_picks_plain`'s."""
    gains = greedy_pick.listed_gains(lists)
    if state is None:
        return lazy_plain(rows, k, excluded, gains=gains)
    state = lazy_picks_plain(rows, k, state, ub, swept, gains=gains)
    return (*state.out, swept)


def _launch(counter: str, fn: str, argtypes, rows: torch.Tensor, m: int,
            n: int, w: int, k: int, ex: torch.Tensor, extra=(), tail=()):
    """Outputs (seeds, sel_rows, covered, gains, tiles_swept) of m solves
    from one launch of ``fn``; ``extra`` tensors go after the tile
    bounds, ``tail`` integers after the tile size."""
    dev = rows.device
    out = greedy_pick.outputs(m, k, w, dev)
    ub, swept = fresh_bounds(m, n, dev)
    if m * n * k == 0:
        return (*out, swept)
    keys = torch.zeros((m, k), dtype=torch.int64, device=dev)
    taken = torch.zeros((m, n), dtype=torch.uint8, device=dev)
    ops.launch(counter, "lazy_greedy", fn, argtypes,
               rows.data_ptr(), ex.data_ptr(), keys.data_ptr(),
               taken.data_ptr(), ub.data_ptr(),
               *(t.data_ptr() for t in extra), swept.data_ptr(),
               *(o.data_ptr() for o in out), m, n, w, k, ex.shape[1],
               TILE_ROWS, *tail)
    return (*out, swept)


def lazy_dense(rows: torch.Tensor, k: int, ex: torch.Tensor,
               cap: int | None = None, stats: dict | None = None):
    """The dense layout: each pick sweeps the rows of the tiles its
    bounds keep (``lazy_greedy``) and counts each swept tile's residual;
    after the first pick whose residual over all tiles is at most ``cap``
    (default ``greedy_pick.list_room``; 0: never) the picks go on over
    the list of the residual (``greedy_pick.residual_lists``, then
    :func:`lazy_compact` with the tile bounds as they stand: both layouts
    bound the same 32-row tiles).  Machines stop where their gains run
    out; ``tiles_swept`` sums both launches'.  ``ex`` from
    ``greedy_pick.excluded_ids``; ``stats`` as ``greedy_pick.hand_over``."""
    m, n, w = rows.shape
    if m * n * k == 0:
        return (*greedy_pick.outputs(m, k, w, rows.device),
                torch.zeros((m,), dtype=torch.int32, device=rows.device))
    cap = greedy_pick.list_room(m, n, w) if cap is None else cap
    state, ub, swept = lazy_dense_picks(rows, k, ex, cap)
    if greedy_pick.hand_over("lazy_greedy", state, k, stats):
        lazy_compact(rows, k, ex, greedy_pick.residual_lists(rows, state, cap),
                     state, ub, swept)
    return (*state.out, swept)


def lazy_dense_picks(rows: torch.Tensor, k: int, ex: torch.Tensor, cap: int):
    """The dense picks of :func:`lazy_dense` up to their handover (m, n,
    k >= 1) -> (the ``greedy_pick.Partial``, the tile bounds,
    tiles_swept): one ``lazy_greedy`` launch and its tally's read on the
    card, :func:`lazy_dense_plain` on the CPU."""
    m, n, w = rows.shape
    if not ops.on_card(rows, ex):
        return lazy_dense_plain(rows, k, ex, cap)
    ops.check(rows, "rows", torch.int32, (m, n, w))
    dev = rows.device
    out = greedy_pick.outputs(m, k, w, dev)
    ub, swept = fresh_bounds(m, n, dev)
    keys = torch.zeros((m, k), dtype=torch.int64, device=dev)
    taken = torch.zeros((m, n), dtype=torch.uint8, device=dev)
    tres = torch.zeros((m, num_row_tiles(n)), dtype=torch.int64, device=dev)
    tally = torch.zeros(k + 2, dtype=torch.int64, device=dev)
    ops.launch("lazy_greedy", "lazy_greedy", "lazy_greedy", _ARGS,
               rows.data_ptr(), ex.data_ptr(), keys.data_ptr(),
               taken.data_ptr(), ub.data_ptr(), tres.data_ptr(),
               tally.data_ptr(), swept.data_ptr(),
               *(o.data_ptr() for o in out), m, n, w, k, ex.shape[1],
               TILE_ROWS, MIN_TILES_PER_BLOCK, cap)
    return greedy_pick.read_tally(out, taken, tally, k), ub, swept


def lazy_compact(rows: torch.Tensor, k: int, ex: torch.Tensor,
                 lists: greedy_pick.RowLists,
                 state: greedy_pick.Partial | None = None,
                 ub: torch.Tensor | None = None,
                 swept: torch.Tensor | None = None):
    """The compact layout: each pick sweeps the listed rows of the tiles
    its bounds keep (``lazy_greedy_compact``, one block a machine); a
    machine stops where its gains run out.  From pick 0, or from a dense
    solve's ``state``, tile bounds ``ub`` and ``swept`` over its
    residual's list, writing the outputs in place."""
    m, n, w = rows.shape
    if not ops.on_card(rows, ex, lists.entries):
        return lazy_compact_plain(rows, k, ex, lists, state, ub, swept)
    ops.check(rows, "rows", torch.int32, (m, n, w))
    dev = rows.device
    if state is None:
        state = greedy_pick.Partial(
            greedy_pick.outputs(m, k, w, dev),
            torch.zeros((m, n), dtype=torch.uint8, device=dev), 0, False, [])
        ub, swept = fresh_bounds(m, n, dev)
    if m * n * k == 0:
        return (*state.out, swept)
    ops.launch("lazy_greedy_compact", "lazy_greedy", "lazy_greedy_compact",
               _COMPACT_ARGS, rows.data_ptr(), ex.data_ptr(),
               lists.row_ids.data_ptr(), lists.counts.data_ptr(),
               lists.starts.data_ptr(), lists.tiles.data_ptr(),
               lists.entries.data_ptr(), state.taken.data_ptr(),
               ub.data_ptr(), swept.data_ptr(),
               *(o.data_ptr() for o in state.out), m, n, w, k, ex.shape[1],
               state.p0)
    return (*state.out, swept)


def greedy_maxcover_lazy(rows: torch.Tensor, k: int, excluded=None,
                         stats: dict | None = None):
    """All k picks of every machine of ``rows`` int32 [m, n, W] ->
    (seeds, sel_rows, covered, gains, tiles_swept): the list
    (``greedy_pick.row_lists``), then the layout it chose (the dense one
    may hand over to the compact picks, :func:`lazy_dense`); ``excluded``
    int32 [E] or [m, E] row ids are never picked.  ``stats`` gets the
    layout, the non-zero words, the listed rows and, on the dense layout,
    the handover."""
    m, n, w = rows.shape
    ex = greedy_pick.excluded_ids(excluded, m, rows.device)
    ops.on_card(rows, ex)                  # raises on mixed devices
    if m * n * k == 0:
        return (*greedy_pick.outputs(m, k, w, rows.device),
                torch.zeros((m,), dtype=torch.int32, device=rows.device))
    lists = greedy_pick.row_lists(rows)
    greedy_pick.report(stats, lists)
    if lists.entries is None:
        return lazy_dense(rows, k, ex, stats=stats)
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
