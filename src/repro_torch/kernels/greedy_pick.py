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
(``greedy_pick``), which re-reads every row in each pick over all SMs
while that pays: it counts the residual (the words a list would hold
now) as it sweeps, hands over to the compact picks over the list of the
residual once that fits the compact layout's room
(:func:`greedy_dense`), and stops where every machine's gains run out.
Both layouts give the same bits; ``ops.LAUNCHES``, ``ops.HANDOVERS``
and ``stats`` show which ran and where the handover came.  The query
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
from repro_torch.kernels import ops, smem_budget, topk_gain

# The contract checker's declaration (``repro_torch/analysis/contracts.py``):
# a machine-axis solve's launches, by layout (the dense one handing over
# once), and the scan reference's none.
CONTRACT = dict(
    family="greedy_pick",
    dtypes=("bool", "int8", "int32", "int64", "uint8"),
    variants=dict(
        resident=dict(launches={"compact_rows": 1, "greedy_pick_compact": 1}),
        dense=dict(launches={"greedy_pick": 1, "compact_rows": 1,
                             "greedy_pick_compact": 1}),
        scan_ref=dict(launches={}),
    ),
)

_ARGS = [ops.PTR] * 9 + [ops.I64] * 6
_BATCH_ARGS = [ops.PTR] * 8 + [ops.I64] * 6
_COMPACT_ARGS = [ops.PTR] * 10 + [ops.I64] * 4
_COMPACT_PICK_ARGS = [ops.PTR] * 12 + [ops.I64] * 6
# ``kTileRows`` in ``csrc/greedy_core.cuh``: the list keeps the rows of
# each tile of this many rows together (a warp lane a row), the lazy
# solve's tiles.
LIST_TILE_ROWS = 32
# The layout rule (:func:`compact_pays`) and the query groups:
# ``smem_budget``'s model.
MAX_GROUP = smem_budget.MAX_GROUP
compact_capacity = smem_budget.compact_capacity
list_room = smem_budget.list_room
query_groups = smem_budget.query_groups


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


def compact_pays(entries: int, words: int, m: int) -> bool:
    """The compact layout pays for a list of ``entries`` non-zero words of
    ``words`` dense words over ``m`` machines."""
    return entries <= compact_capacity(words, m)


class Partial(NamedTuple):
    """A machine-axis solve after its dense picks (``greedy_pick`` or
    ``lazy_greedy``, or their plain versions)."""
    out: tuple             # (seeds, sel_rows, covered, gains): picks
    #                        0 .. p0 - 1 made, the later ones pre-filled
    taken: torch.Tensor    # [m, n] excluded and picked rows (bool on the
    #                        CPU, uint8 on the card)
    p0: int                # picks made
    spent: bool            # every machine's best gain was <= 0 at pick p0
    residual: list         # per swept pick, its residual words over all
    #                        machines before its commit


def start(rows: torch.Tensor, k: int, excluded: torch.Tensor) -> Partial:
    """A fresh solve of rows [m, n, W]: pre-filled outputs, the excluded
    rows taken (bool), no pick made."""
    m, n, w = rows.shape
    taken = torch.zeros((m, n), dtype=torch.bool, device=rows.device)
    ok = (excluded >= 0) & (excluded < n)
    mach = torch.arange(m, device=rows.device)[:, None].expand_as(excluded)
    taken[mach[ok], excluded[ok].long()] = True
    return Partial(outputs(m, k, w, rows.device), taken, 0, False, [])


def residual_words(rows: torch.Tensor, covered: torch.Tensor,
                   taken: torch.Tensor) -> torch.Tensor:
    """int64 [m]: each machine's residual, the non-zero words of row &
    ~covered over its rows not taken — the entries a compaction against
    this cover lists (:func:`compact_rows_plain`)."""
    nz = (rows & ~covered[:, None, :]) != 0
    return (nz & ~taken.bool()[:, :, None]).sum((1, 2))


def plain_picks(rows: torch.Tensor, k: int, state: Partial, pick,
                cap: int = 0, residual=None, stop: bool = False) -> Partial:
    """Picks state.p0 .. k - 1 of rows [m, n, W]: each ``pick(rows,
    covered, taken) -> (best gain, best index)`` committed on the device
    as the reference's loop body (a best gain <= 0 gives seed -1, gain 0
    and a zero row), the outputs and taken flags of ``state`` updated in
    place.  With ``stop`` the picks end at the first whose best gain is
    <= 0 on every machine (the later ones keep their pre-fill: the same
    outputs; a host read a pick).  ``residual(covered, taken)``, if
    given, counts each pick's residual before its commit, and with ``cap``
    > 0 the picks end after the first whose count is at most ``cap`` (the
    dense kernels' handover)."""
    seeds, sel_rows, covered, gains = state.out
    taken = state.taken
    counts = list(state.residual)
    ar = torch.arange(rows.shape[0], device=rows.device)
    for i in range(state.p0, k):
        best_gain, best = pick(rows, covered, taken.bool())
        best = best.long()
        take = best_gain > 0
        if stop and not bool(take.any()):
            return state._replace(p0=i, spent=True, residual=counts)
        if residual is not None:
            counts.append(int(residual(covered, taken)))
        row = torch.where(take[:, None], rows[ar, best], 0)
        covered |= row
        seeds[:, i] = torch.where(take, best.to(torch.int32), -1)
        sel_rows[:, i] = row
        gains[:, i] = torch.where(take, best_gain, 0)
        taken[ar, best] |= take.to(taken.dtype)
        if cap > 0 and residual is not None and counts[-1] <= cap:
            return state._replace(p0=i + 1, residual=counts)
    return state._replace(p0=k, residual=counts)


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
    state = start(rows, k, excluded)
    if rows.shape[1] == 0:
        return state.out
    return plain_picks(rows, k, state, pick).out


def greedy_dense_plain(rows: torch.Tensor, k: int, excluded: torch.Tensor,
                       cap: int = 0) -> Partial:
    """The dense kernel's picks (``greedy_pick``) in plain PyTorch: from
    pick 0, each counting the residual over all machines
    (:func:`residual_words`), until the gains run out, k, or the first
    pick whose residual is at most ``cap`` (0: never)."""
    return plain_picks(
        rows, k, start(rows, k, excluded), topk_gain.best_gain_index_plain,
        cap, lambda covered, taken: residual_words(rows, covered, taken).sum(),
        stop=True)


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


def compact_rows_plain(rows: torch.Tensor, covered=None,
                       taken=None) -> RowLists:
    """The compact layout of rows int32 [m, n, W] in plain PyTorch, in
    the canonical order: each machine's listed rows ascending, entries
    machine by machine and row by row (the kernel's order is free).
    With ``covered`` [m, W] and ``taken`` [m, n] (a dense solve's state at
    its handover) it lists the residual instead: the rows not taken,
    their words & ~covered."""
    m, n, w = rows.shape
    if covered is not None:
        rows = torch.where(taken.bool()[:, :, None], 0,
                           rows & ~covered[:, None, :])
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
                         lists: RowLists, state: Partial | None = None):
    """The compact layout's picks in plain PyTorch, each pick's gains swept
    from ``lists``, stopping where the gains run out: from pick 0, or
    from a dense solve's ``state`` over the list of its residual
    (:func:`residual_lists`)."""
    gains = listed_gains(lists)
    state = start(rows, k, excluded) if state is None else state
    return plain_picks(rows, k, state, lambda rows, covered, taken:
                       topk_gain.best_of(gains(covered), taken),
                       stop=True).out


def compact_rows_launch(rows: torch.Tensor, cap: int, covered=None,
                        taken=None):
    """One launch of ``compact_rows`` over rows int32 [m, n, W] on the
    card into ``cap`` entries -> (the list, its ``nonzero_words`` not
    read yet, and the int64 [1] count on the card, which also counts the
    entries past ``cap``; those are not written).  ``covered`` and
    ``taken`` (uint8) as :func:`compact_rows_plain`'s."""
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
    if covered is not None:
        ops.check(covered, "covered", torch.int32, (m, w))
        ops.check(taken, "taken", torch.uint8, (m, n))
    ops.launch("compact_rows", "greedy_pick", "compact_rows", _COMPACT_ARGS,
               rows.data_ptr(),
               *((None, None) if covered is None else
                 (covered.data_ptr(), taken.data_ptr())),
               total.data_ptr(), listed.data_ptr(),
               row_ids.data_ptr(), counts.data_ptr(), starts.data_ptr(),
               tiles.data_ptr(), entries.data_ptr(), m, n, w, cap)
    return RowLists(listed, row_ids, counts, starts, tiles, entries,
                    -1), total


def compact_rows(rows: torch.Tensor, cap: int, covered=None,
                 taken=None) -> RowLists:
    """:func:`compact_rows_launch` with its count read back to the host
    (8 bytes)."""
    lists, total = compact_rows_launch(rows, cap, covered, taken)
    return lists._replace(nonzero_words=int(total))


def residual_lists(rows: torch.Tensor, state: Partial, cap: int) -> RowLists:
    """The compact layout of what a dense solve ``state`` leaves: the
    untaken rows' words & ~cover (one ``compact_rows`` into ``cap``
    entries and its count's read on the card, its plain version on the
    CPU).  The dense picks handed over at a residual count of at most
    ``cap``, which bounds this list (the cover and the taken rows only
    grew since), so a longer list is a fault: it raises."""
    covered, taken = state.out[2], state.taken
    if ops.on_card(rows, covered, taken):
        lists = compact_rows(rows, cap, covered, taken)
    else:
        lists = compact_rows_plain(rows, covered, taken)
    if lists.nonzero_words > cap:
        raise RuntimeError(f"the residual's list holds {lists.nonzero_words} "
                           f"entries, past the {cap} its handover allowed")
    return lists._replace(entries=lists.entries[:lists.nonzero_words])


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
        lists = compact_rows(rows, list_room(m, n, w))
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


def query_plan(lib: str, b: int, num_words: int, device) -> tuple[int, int]:
    """:func:`query_groups` with the shared-memory budget of ``lib``'s
    query-axis kernel on the CUDA ``device`` (``smem_budget.query_budget``)."""
    return query_groups(b, num_words, smem_budget.query_budget(lib, device))


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


def read_tally(out: tuple, taken: torch.Tensor, tally: torch.Tensor,
               k: int) -> Partial:
    """The :class:`Partial` a dense launch leaves, from its ``tally``
    (int64 [k + 2]: the swept picks' residual counts, then the picks made
    and whether every machine's gains ran out), read in one host read."""
    t = tally.tolist()
    return Partial(out, taken, t[k], bool(t[k + 1]), t[:t[k]])


def hand_over(kernel: str, state: Partial, k: int,
              stats: dict | None) -> bool:
    """Whether the dense picks of ``state`` hand over to the compact ones
    (some machine's gains are left, and picks).  Counts a handover in
    ``ops.HANDOVERS[kernel]``; ``stats`` gets ``handover_pick`` (the
    compact layout's first pick, or None), ``spent_pick`` (the pick at
    which the dense launch found every machine's gains run out, or None)
    and ``residual`` (the swept picks' counts)."""
    handed = not state.spent and state.p0 < k
    ops.HANDOVERS[kernel] += handed
    if stats is not None:
        stats.update(handover_pick=state.p0 if handed else None,
                     spent_pick=state.p0 if state.spent else None,
                     residual=state.residual)
    return handed


def greedy_dense(rows: torch.Tensor, k: int, ex: torch.Tensor,
                 cap: int | None = None, stats: dict | None = None):
    """The dense layout: each pick sweeps every row of ``rows`` int32
    [m, n, W] over all SMs (``greedy_pick``) and counts the residual
    (:func:`residual_words`) over all machines; after the first pick whose
    count is at most ``cap`` (default :func:`list_room`; 0: never) the
    picks go on over the list of the residual (:func:`residual_lists`,
    then :func:`greedy_compact` from there).  A machine whose gains ran
    out sweeps no more, and the launch ends when every machine's have.
    ``ex`` from :func:`excluded_ids`; ``stats`` as :func:`hand_over`."""
    m, n, w = rows.shape
    if m * n * k == 0:
        return outputs(m, k, w, rows.device)
    cap = list_room(m, n, w) if cap is None else cap
    state = dense_picks(rows, k, ex, cap)
    if hand_over("greedy_pick", state, k, stats):
        greedy_compact(rows, k, ex, residual_lists(rows, state, cap), state)
    return state.out


def dense_picks(rows: torch.Tensor, k: int, ex: torch.Tensor,
                cap: int) -> Partial:
    """The dense picks of :func:`greedy_dense` up to their handover (m, n,
    k >= 1): one ``greedy_pick`` launch and its tally's read on the card,
    :func:`greedy_dense_plain` on the CPU."""
    m, n, w = rows.shape
    if not ops.on_card(rows, ex):
        return greedy_dense_plain(rows, k, ex, cap)
    ops.check(rows, "rows", torch.int32, (m, n, w))
    out = outputs(m, k, w, rows.device)
    keys = torch.zeros((m, k), dtype=torch.int64, device=rows.device)
    taken = torch.zeros((m, n), dtype=torch.uint8, device=rows.device)
    tally = torch.zeros(k + 2, dtype=torch.int64, device=rows.device)
    ops.launch("greedy_pick", "greedy_pick", "greedy_pick", _ARGS,
               rows.data_ptr(), ex.data_ptr(), keys.data_ptr(),
               taken.data_ptr(), tally.data_ptr(),
               *(o.data_ptr() for o in out), m, n, w, k, ex.shape[1], cap)
    return read_tally(out, taken, tally, k)


def greedy_compact(rows: torch.Tensor, k: int, ex: torch.Tensor,
                   lists: RowLists, state: Partial | None = None):
    """The compact layout: every pick sweeps ``lists`` (from
    :func:`row_lists`, entries not None) and commits from ``rows``
    (``greedy_pick_compact``, one block a machine); a machine stops where
    its gains run out.  From pick 0, or from a dense solve's ``state``
    over its residual's list, writing its outputs in place."""
    m, n, w = rows.shape
    if not ops.on_card(rows, ex, lists.entries):
        return greedy_compact_plain(rows, k, ex, lists, state)
    ops.check(rows, "rows", torch.int32, (m, n, w))
    if m * n * k == 0:
        return outputs(m, k, w, rows.device)
    if state is None:
        state = Partial(outputs(m, k, w, rows.device),
                        torch.zeros((m, n), dtype=torch.uint8,
                                    device=rows.device), 0, False, [])
    ops.launch("greedy_pick_compact", "greedy_pick", "greedy_pick_compact",
               _COMPACT_PICK_ARGS, rows.data_ptr(), ex.data_ptr(),
               lists.listed.data_ptr(), lists.row_ids.data_ptr(),
               lists.counts.data_ptr(), lists.starts.data_ptr(),
               lists.entries.data_ptr(), state.taken.data_ptr(),
               *(o.data_ptr() for o in state.out), m, n, w, k, ex.shape[1],
               state.p0)
    return state.out


def greedy_maxcover_resident(rows: torch.Tensor, k: int, excluded=None,
                             stats: dict | None = None):
    """All k picks of every machine of ``rows`` int32 [m, n, W]: the
    list (:func:`row_lists`), then the layout it chose (the dense one
    may hand over to the compact picks, :func:`greedy_dense`);
    ``excluded`` int32 [E] or [m, E] row ids never picked.  ``stats``
    gets the layout, the non-zero words, the listed rows and, on the
    dense layout, the handover (:func:`hand_over`)."""
    m, n, w = rows.shape
    ex = excluded_ids(excluded, m, rows.device)
    ops.on_card(rows, ex)                  # raises on mixed devices
    if m * n * k == 0:
        return outputs(m, k, w, rows.device)
    lists = row_lists(rows)
    report(stats, lists)
    if lists.entries is None:
        return greedy_dense(rows, k, ex, stats=stats)
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
