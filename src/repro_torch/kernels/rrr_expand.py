"""Fused packed BFS expansion step (``csrc/rrr_expand.cu``), both
gather layouts, with their plain PyTorch versions.

Replaces ``repro/kernels/rrr_expand.py``: ``rrr_expand_step_resident_pallas``
(TPU kernel #1) and ``rrr_expand_step_pallas`` (#2).  One step computes

    hit = OR_s frontier[fwd_nbr[:, s]] & mask[:, s]
    new = hit & ~visited;  visited_out = visited | new

where the mask word is ``plane[gidx[u, s]]`` (resident layout; ``gidx``
equal to ``plane.shape[0]`` reads a zero row — the sentinel of invalid
slots) or ``gmask[u, s]`` (streamed layout, pre-gathered).  ``fwd_nbr``
is pre-clipped to 0 at invalid slots.  The kernel is direction-agnostic,
so the cascade's forward diffusion uses it too.  Bound on the H100:
bytes; see the CUDA source for the design.  Both wrappers take four
optional tensors, which their callers' loops carry from step to step:

  * ``slots`` int32 [n]: row ``u``'s valid slots come first and number
    ``slots[u]``; the rest of the row is never read (without it every
    slot is read, and the sentinel may stand anywhere in a row);
  * ``lines`` uint8 [n, ceil(W / 32)]: the frontier's line summary
    (:func:`line_summary`), non-zero where a 32-word line may hold a set
    bit; a line whose byte is zero is never read (without it every line
    is read).  Extra set bytes cost loads and never change a word;
  * ``next_lines`` (same shape) receives the new frontier's summary, and
    ``count`` int32 [1] the number of its non-zero lines, so a loop stops
    on 4 bytes instead of ``frontier.any()``.

The IC sampler's step is ``rrr_expand_push_ic`` (kernel
``rrr_expand_ic``), a push over a list of the frontier's live words:
each live word ``(v, w)`` draws the IC coin of sample ``32 w + b`` on
each valid reverse slot of ``v`` (``kernels.coins``), hashed only behind
a set frontier bit, and ORs the fired bits into the word ``(u, w)`` of
its in-neighbour ``u``, updating ``visited`` in place and appending each
newly live word to the next list once.  No coin plane is built and no
pass over the ``[n, W]`` planes is made: the step zeroes the frontier
words it reads, so the sampler ping-pongs two frontier planes.  Its
plain version is ``expand_step_ic_push_plain``.  ``rrr_expand_step_ic``
is the dense entry point around it (frontier and visited in, new
frontier and visited out), equal word for word to
``rrr_expand_step_resident`` over ``coins.coin_plane`` and to the pull
``expand_step_ic_plain``.

The forward cascade's IC step is ``cascade_step_ic`` (kernel
``cascade_ic``), a pull over the reverse table that draws each live edge
in the kernel: the coin of in-edge ``r`` of ``v`` in simulation ``s`` is
the reference's per-lane cascade draw, element ``v * chunk + r % chunk``
of ``uniform(fold_in(fold_in(key, r // chunk), s), (n, chunk))``, hashed
only behind a frontier bit that can still become new.  Its keys come
from ``cascade_keys``, its plain version is ``cascade_step_ic_plain``;
both equal ``rrr_expand_step`` over the cascade's live-edge plane word
for word, so the spread builds no plane.

LT has one live in-edge per (sample or simulation, vertex): slot
``chosen`` = the count of ``cumw[v, j] <= r`` over the padded row, live
below the in-degree (``cumw`` the reference's blocked cumulative
weights).  The LT sampler's step is
``rrr_expand_push_lt`` (kernel ``rrr_expand_lt``): the IC push's list
and planes over the graph's reverse CSR (``graphs.csr.lt_reverse``:
each row's ``deg`` smallest sums of its padded row, ascending, which
give the same ``chosen`` and pad nothing), with bit ``b`` of live word
``(v, w)`` drawing ``r = uniform(key)[(32 w + b) * n + v]`` and pushing
into the word of ``src[indptr[v] + chosen]``; plain version
``expand_step_lt_push_plain``, dense entry point
``rrr_expand_step_lt``.  The LT cascade's step, on the padded table
and ``lt_tables``, which also codes each row's in-degree, is
``cascade_step_lt`` (kernel ``cascade_lt``), a pull whose simulation
``s`` draws ``r = uniform(fold_in(key, s), (n,))[v]`` only for an open
bit that some in-neighbour's frontier word holds (keys from
``lt_cascade_keys``); plain version ``cascade_step_lt_plain``.  Both
equal the expansions over the reference's LT selection plane word for
word.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitset, prng
from repro_torch.core.prng import Key
from repro_torch.kernels import coins, ops

# The contract checker's declaration (``repro_torch/analysis/contracts.py``):
# the kernel sampler's launches a BFS step, by layout and model.
CONTRACT = dict(
    family="rrr_expand",
    dtypes=("bool", "float32", "int32", "int64", "uint8"),
    variants=dict(
        resident=dict(launches={"rrr_expand_ic": 1}, per_step=True),
        # lines_kernel<GatheredMask> keeps a 16-byte stack frame
        streamed=dict(launches={"coin_pack": 1, "rrr_expand_streamed": 1},
                      per_step=True, local_memory=("rrr_expand_streamed",)),
        lt=dict(launches={"rrr_expand_lt": 1}, per_step=True),
    ),
)

_RESIDENT_ARGS = [ops.PTR] * 11 + [ops.I64] * 4
_STREAMED_ARGS = [ops.PTR] * 10 + [ops.I64] * 3
_IC_ARGS = [ops.PTR, ops.I64] + [ops.PTR] * 8 + [ops.I64] * 5
_CASCADE_ARGS = [ops.PTR] * 8 + [ops.I64] * 7
_LT_ARGS = ([ops.PTR, ops.I64] + [ops.PTR] * 5 + [ops.I64] * 2
            + [ops.PTR] * 3 + [ops.I64] * 3)
_CASCADE_LT_ARGS = [ops.PTR] * 9 + [ops.I64] * 5

LINE_WORDS = 32     # words a line of the line summary


def num_lines(w: int) -> int:
    """Lines of the line summary of a W-word row."""
    return -(-w // LINE_WORDS)


def line_summary(frontier: torch.Tensor) -> torch.Tensor:
    """uint8 [n, ceil(W / 32)]: 1 where line ``l`` of row ``v``, words
    ``32 l`` to ``32 l + 31``, holds a set bit, else 0."""
    n, w = frontier.shape
    lines = num_lines(w)
    padded = torch.nn.functional.pad(frontier, (0, lines * LINE_WORDS - w))
    return (padded.view(n, lines, LINE_WORDS) != 0).any(2).to(torch.uint8)


def _finish(hit, visited, next_lines=None, count=None):
    new = hit & ~visited
    if next_lines is not None or count is not None:
        summary = line_summary(new)
        if next_lines is not None:
            next_lines.copy_(summary)
        if count is not None:
            count.fill_(int(summary.sum()))
    return new, visited | new


def _read_frontier(frontier, lines):
    """The frontier as the step reads it: lines whose summary byte is 0
    read as zero."""
    if lines is None:
        return frontier
    keep = lines.bool().repeat_interleave(LINE_WORDS, 1)[:, :frontier.shape[1]]
    return torch.where(keep, frontier, 0)


def _slot(fwd_nbr, slots, s):
    """(source rows of slot ``s``, rows where it is read or None)."""
    if slots is None:
        return fwd_nbr[:, s].long(), None
    ok = s < slots
    return torch.where(ok, fwd_nbr[:, s], 0).long(), ok


def expand_step_resident_plain(frontier, visited, fwd_nbr, gidx, plane,
                               slots=None, lines=None, next_lines=None,
                               count=None):
    rows = plane.shape[0]
    f = _read_frontier(frontier, lines)
    hit = torch.zeros_like(frontier)
    for s in range(fwd_nbr.shape[1] if rows else 0):
        v, ok = _slot(fwd_nbr, slots, s)
        g = gidx[:, s].long()
        ok = g < rows if ok is None else ok & (g < rows)
        m = plane[g.clamp(0, rows - 1)] & torch.where(
            ok, -1, 0).to(plane.dtype)[:, None]
        hit |= f[v] & m
    return _finish(hit, visited, next_lines, count)


def expand_step_plain(frontier, visited, fwd_nbr, gmask, slots=None,
                      lines=None, next_lines=None, count=None):
    f = _read_frontier(frontier, lines)
    hit = torch.zeros_like(frontier)
    for s in range(fwd_nbr.shape[1]):
        v, ok = _slot(fwd_nbr, slots, s)
        h = f[v] & gmask[:, s]
        hit |= h if ok is None else torch.where(ok[:, None], h, 0)
    return _finish(hit, visited, next_lines, count)


def _options(n, w, slots, lines, next_lines, count) -> list:
    """Check the optional inputs and outputs; returns those given."""
    if slots is not None:
        ops.check(slots, "slots", torch.int32, (n,))
    for name, t in (("lines", lines), ("next_lines", next_lines)):
        if t is not None:
            ops.check(t, name, torch.uint8, (n, num_lines(w)))
    if count is not None:
        ops.check(count, "count", torch.int32, (1,))
    return [t for t in (slots, lines, next_lines, count) if t is not None]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _empty(frontier, visited, count):
    """The outputs of a step over no words."""
    if count is not None:
        count.zero_()
    return torch.empty_like(frontier), torch.empty_like(visited)


def rrr_expand_step_resident(frontier, visited, fwd_nbr, gidx, plane, *,
                             slots=None, lines=None, next_lines=None,
                             count=None):
    """Resident layout: frontier/visited int32 [n, W], fwd_nbr/gidx int32
    [n, df] (gidx in [0, rows]), plane int32 [rows, W], the optional
    ``slots``, ``lines``, ``next_lines`` and ``count`` of the module's
    docstring -> (new_frontier, new_visited)."""
    n, w = frontier.shape
    opts = _options(n, w, slots, lines, next_lines, count)
    if not ops.on_card(frontier, visited, fwd_nbr, gidx, plane, *opts):
        return expand_step_resident_plain(frontier, visited, fwd_nbr, gidx,
                                          plane, slots, lines, next_lines,
                                          count)
    df = fwd_nbr.shape[1]
    ops.check(frontier, "frontier", torch.int32, (n, w))
    ops.check(visited, "visited", torch.int32, (n, w))
    ops.check(fwd_nbr, "fwd_nbr", torch.int32, (n, df))
    ops.check(gidx, "gidx", torch.int32, (n, df))
    ops.check(plane, "plane", torch.int32, (None, w))
    if n * w == 0:
        return _empty(frontier, visited, count)
    newf, viso = torch.empty_like(frontier), torch.empty_like(visited)
    ops.launch("rrr_expand_resident", "rrr_expand", "rrr_expand_resident",
               _RESIDENT_ARGS, frontier.data_ptr(), visited.data_ptr(),
               fwd_nbr.data_ptr(), gidx.data_ptr(), plane.data_ptr(),
               _ptr(slots), _ptr(lines), newf.data_ptr(), viso.data_ptr(),
               _ptr(next_lines), _ptr(count), n, df, w, plane.shape[0])
    return newf, viso


def rrr_expand_step(frontier, visited, fwd_nbr, gmask, *, slots=None,
                    lines=None, next_lines=None, count=None):
    """Streamed layout: gmask int32 [n, df, W], zero at invalid slots (or,
    with ``slots``, anything past each row's valid slots, which is never
    read); the other inputs as :func:`rrr_expand_step_resident`."""
    n, w = frontier.shape
    opts = _options(n, w, slots, lines, next_lines, count)
    if not ops.on_card(frontier, visited, fwd_nbr, gmask, *opts):
        return expand_step_plain(frontier, visited, fwd_nbr, gmask, slots,
                                 lines, next_lines, count)
    df = fwd_nbr.shape[1]
    ops.check(frontier, "frontier", torch.int32, (n, w))
    ops.check(visited, "visited", torch.int32, (n, w))
    ops.check(fwd_nbr, "fwd_nbr", torch.int32, (n, df))
    ops.check(gmask, "gmask", torch.int32, (n, df, w))
    if n * w == 0:
        return _empty(frontier, visited, count)
    newf, viso = torch.empty_like(frontier), torch.empty_like(visited)
    ops.launch("rrr_expand_streamed", "rrr_expand", "rrr_expand_streamed",
               _STREAMED_ARGS, frontier.data_ptr(), visited.data_ptr(),
               fwd_nbr.data_ptr(), gmask.data_ptr(), _ptr(slots),
               _ptr(lines), newf.data_ptr(), viso.data_ptr(),
               _ptr(next_lines), _ptr(count), n, df, w)
    return newf, viso


def expand_step_ic_plain(frontier, visited, nbr_c, gidx, prob_p,
                         keys: list[Key], chunk: int):
    """The IC step as a pull over the forward slots, in plain PyTorch
    (an oracle that shares no code with the push, which the tests hold
    it against): per forward slot, the live (u, w) — a valid slot
    (``gidx`` below the sentinel ``n * d_pad``) with ``p > 0`` whose
    frontier word is non-zero — and their set bits, hashed through
    ``Key.uniform_at`` at the reference's flat draw indices.  Builds no
    plane; -> (new frontier, new visited)."""
    n, d_pad = prob_p.shape
    sentinel = n * d_pad
    p_flat = prob_p.reshape(-1)
    hit = torch.zeros_like(frontier)
    for s in range(nbr_c.shape[1]):
        g = gidx[:, s].long()
        p = torch.where(g < sentinel, p_flat[g.clamp(max=sentinel - 1)], 0.0)
        v = nbr_c[:, s].long()
        f = frontier[v]
        u, w = torch.nonzero((f != 0) & (p > 0)[:, None], as_tuple=True)
        if u.numel() == 0:
            continue
        live = bitset.unpack_words(f[u, w][:, None], bitset.WORD_BITS)
        i, b = torch.nonzero(live, as_tuple=True)        # set bits of each
        ui = u[i]
        rslot = g[ui] - v[ui] * d_pad
        c, j = rslot // chunk, rslot % chunk
        flat = ((bitset.WORD_BITS * w[i] + b) * n + v[ui]) * chunk + j
        fire = torch.zeros_like(b, dtype=torch.bool)
        for ci, key in enumerate(keys):
            sel = c == ci
            fire[sel] = key.uniform_at(flat[sel]) < p[ui[sel]]
        word = torch.zeros(u.numel(), dtype=torch.int64, device=u.device)
        word.index_add_(0, i[fire], torch.ones_like(b[fire]) << b[fire])
        hit[u, w] |= bitset.to_words(word)
    return _finish(hit, visited)


def live_words(frontier: torch.Tensor) -> torch.Tensor:
    """The push's word list of a dense frontier: int32 flat indices
    ``v * W + w`` of its non-zero words, ascending."""
    return torch.nonzero(frontier.reshape(-1)).reshape(-1).to(torch.int32)


def _check_planes(words, frontier, visited, next_frontier, next_words,
                  next_count):
    """The push's list and planes, either model."""
    n, w = frontier.shape
    ops.check(words, "words", torch.int32, (None,))
    for name, t in (("frontier", frontier), ("visited", visited),
                    ("next_frontier", next_frontier)):
        ops.check(t, name, torch.int32, (n, w))
    ops.check(next_words, "next_words", torch.int32, (n * w,))
    ops.check(next_count, "next_count", torch.int32, (1,))
    planes = {t.data_ptr() for t in (frontier, visited, next_frontier)}
    if len(planes) != 3:
        raise ValueError("frontier, visited and next_frontier must be "
                         "three distinct planes")


def _check_lists(words, frontier, visited, nbr, next_frontier, next_words,
                 next_count):
    """The push's list, planes and padded reverse table."""
    _check_planes(words, frontier, visited, next_frontier, next_words,
                  next_count)
    ops.check(nbr, "nbr", torch.int32, (frontier.shape[0], None))


def refuse_wide(n: int, w: int, kernel: str) -> None:
    """The pushes' limit: their word lists hold the flat index ``v * W +
    w`` in int32, so an [n, W] plane of 2^31 words or more is refused
    (on every device, before anything is read)."""
    if n * w >= 2**31:
        raise ValueError(f"{kernel}: n x W = {n * w} words do not fit the "
                         "int32 word list")


def _check_push(words, frontier, visited, nbr, prob_p, keys, chunk,
                next_frontier, next_words, next_count):
    n = frontier.shape[0]
    d_pad = prob_p.shape[1]
    if len(keys) * chunk != d_pad:
        raise ValueError(f"{len(keys)} chunk keys x {chunk} slots != "
                         f"d_pad {d_pad}")
    _check_lists(words, frontier, visited, nbr, next_frontier, next_words,
                 next_count)
    ops.check(prob_p, "prob_p", torch.float32, (n, d_pad))
    if nbr.shape[1] > d_pad:
        raise ValueError(f"nbr has {nbr.shape[1]} slots, prob_p {d_pad}")


# Entries x row width of one pass of the plain push (bounds its memory
# on the full-size and hub-row inputs it is held against on the card).
_PLAIN_SLOTS = 1 << 24


def _fired(idx, f, nbr, prob_p, keys: list[Key], chunk: int, n: int,
           w_total: int) -> torch.Tensor:
    """``(u * W + w) * 32 + b`` of each coin that fires behind the live
    words ``idx`` (frontier words ``f``): bit ``b`` of ``(v, w)`` on each
    valid reverse slot of ``v`` with ``p > 0``."""
    v, w = idx // w_total, idx % w_total
    e, s = torch.nonzero((nbr[v] >= 0) & (prob_p[v, :nbr.shape[1]] > 0),
                         as_tuple=True)
    live = bitset.unpack_words(f[e][:, None], bitset.WORD_BITS)
    i, b = torch.nonzero(live, as_tuple=True)          # set bits of each
    e, s = e[i], s[i]
    ve, we = v[e], w[e]
    c, j = s // chunk, s % chunk
    flat = ((bitset.WORD_BITS * we + b) * n + ve) * chunk + j
    p = prob_p[ve, s]
    fire = torch.zeros_like(b, dtype=torch.bool)
    for ci, key in enumerate(keys):
        sel = c == ci
        fire[sel] = key.uniform_at(flat[sel]) < p[sel]
    tgt = nbr[ve, s].long() * w_total + we
    return (tgt * bitset.WORD_BITS + b)[fire]


def expand_step_ic_push_plain(words, frontier, visited, nbr, prob_p,
                              keys: list[Key], chunk: int, next_frontier,
                              next_words, next_count) -> None:
    """The push step in plain PyTorch, with the kernel's in-place
    contract (:func:`rrr_expand_push_ic`); the next list comes out
    ascending.  Slots with ``nbr >= 0`` are valid."""
    n, w_total = frontier.shape
    idx, f = _take(words, frontier)
    per = max(1, _PLAIN_SLOTS // max(nbr.shape[1], 1))
    fired = [_fired(idx[lo:lo + per], f[lo:lo + per], nbr, prob_p, keys,
                    chunk, n, w_total) for lo in range(0, idx.numel(), per)]
    _settle(fired, idx, visited, next_frontier, next_words, next_count)


def _take(words, frontier):
    """The listed words' flat indices and values, zeroed in the plane."""
    flat_f = frontier.view(-1)
    idx = words.long()
    f = flat_f[idx]
    flat_f[idx] = 0
    return idx, f


def _settle(fired, idx, visited, next_frontier, next_words,
            next_count) -> None:
    """The push's writes, from the bits ``(u * W + w) * 32 + b`` that
    reach their targets: visited and the next plane gain the new ones,
    and the next list (ascending) the words that turn non-zero."""
    flat_vis, flat_next = visited.view(-1), next_frontier.view(-1)
    hit_bits = torch.unique(torch.cat(fired) if fired else idx)
    hw, inv = torch.unique_consecutive(hit_bits // bitset.WORD_BITS,
                                       return_inverse=True)
    word = torch.zeros(hw.numel(), dtype=torch.int64, device=hw.device)
    word.index_add_(0, inv, torch.ones_like(hit_bits)
                    << (hit_bits % bitset.WORD_BITS))
    hit = bitset.to_words(word)
    old = flat_vis[hw]
    new = hit & ~old
    flat_vis[hw] = old | new
    old_next = flat_next[hw]
    flat_next[hw] = old_next | new
    appended = hw[(new != 0) & (old_next == 0)]
    next_words[:appended.numel()] = appended.to(torch.int32)
    next_count.fill_(appended.numel())


def rrr_expand_push_ic(words, frontier, visited, nbr, prob_p,
                       keys: list[Key], chunk: int, next_frontier,
                       next_words, next_count) -> None:
    """One IC step as a push over the live frontier words, in place.

    ``words`` int32 [count]: the flat indices ``v * W + w`` of the
    non-zero words of ``frontier`` int32 [n, W], each once.  ``visited``
    int32 [n, W] gains the step's new bits; ``next_frontier`` int32 [n,
    W], zero on entry, receives them (the new frontier); ``frontier``
    is zeroed at the listed words (so all of it, when the list is
    complete); ``next_words`` int32 [n * W] receives the new frontier's
    non-zero words, each once (ascending in the plain version, in no
    order on the card), and ``next_count`` int32 [1] their number.
    ``nbr`` int32 [n, d] is the reverse adjacency, valid slots first in
    each row, -1 after; ``prob_p`` float32 [n, d_pad] its probabilities;
    one key per chunk of ``chunk`` reverse slots."""
    n, w = frontier.shape
    refuse_wide(n, w, "rrr_expand_ic")
    _check_push(words, frontier, visited, nbr, prob_p, keys, chunk,
                next_frontier, next_words, next_count)
    tensors = (words, frontier, visited, nbr, prob_p, next_frontier,
               next_words, next_count)
    if not ops.on_card(*tensors):
        return expand_step_ic_push_plain(words, frontier, visited, nbr,
                                         prob_p, keys, chunk, next_frontier,
                                         next_words, next_count)
    if words.numel() == 0:
        next_count.zero_()
        return None
    key_words = coins.key_words(keys, frontier.device)
    ops.launch("rrr_expand_ic", "rrr_expand", "rrr_expand_ic", _IC_ARGS,
               words.data_ptr(), words.numel(), frontier.data_ptr(),
               visited.data_ptr(), nbr.data_ptr(), prob_p.data_ptr(),
               key_words.data_ptr(), next_frontier.data_ptr(),
               next_words.data_ptr(), next_count.data_ptr(), n,
               nbr.shape[1], prob_p.shape[1], chunk, w)
    return None


def rrr_expand_step_ic(frontier, visited, nbr, prob_p, keys: list[Key],
                       chunk: int):
    """The dense entry point of the push: frontier/visited int32 [n, W]
    (left untouched), nbr int32 [n, d] (reverse adjacency, valid slots
    first), prob_p float32 [n, d_pad], one key per chunk of ``chunk``
    reverse slots -> (new_frontier, new_visited).  Lists the frontier's
    live words, clones visited and the frontier, then runs
    :func:`rrr_expand_push_ic`."""
    return _dense_step(
        lambda *planes: rrr_expand_push_ic(planes[0], planes[1], planes[2],
                                           nbr, prob_p, keys, chunk,
                                           *planes[3:]),
        frontier, visited)


def _dense_step(push, frontier, visited):
    n, w = frontier.shape
    new_frontier, new_visited = torch.zeros_like(frontier), visited.clone()
    push(live_words(frontier), frontier.clone(), new_visited, new_frontier,
         torch.empty(n * w, dtype=torch.int32, device=frontier.device),
         torch.empty(1, dtype=torch.int32, device=frontier.device))
    return new_frontier, new_visited


def lt_tables(nbr, cumw):
    """The LT kernels' tables from the reference's cumulative weights
    ``cumw`` [n, d]: (the weights with each row ascending, the row codes
    int32 [n]).  A row whose sums decrease somewhere (the rounding of a
    blocked sum) is sorted — the count of sums at or below a draw is the
    same in any order — and coded ``-1 - in_degree``, so the kernels
    search all its d sums; every other row stays as it is, coded with
    its in-degree (its valid slots, ``nbr >= 0``), whose sums alone
    decide a choice."""
    in_deg = (nbr >= 0).sum(1)
    rising = (cumw[:, 1:] >= cumw[:, :-1]).all(1)
    if not bool(rising.all()):
        cumw = cumw.clone()
        cumw[~rising] = cumw[~rising].sort(1).values
    return (cumw.contiguous(),
            torch.where(rising, in_deg, -1 - in_deg).to(torch.int32))


def _lt_slots(cumw, rows, v, r):
    """(slot, live) of the LT draws ``r`` at vertices ``v``: the
    reference's count of ``cumw[v, j] <= r`` over the whole padded row
    (in any order), live below the in-degree (in passes of at most
    ``_PLAIN_SLOTS`` entries)."""
    d = cumw.shape[1]
    per = max(1, _PLAIN_SLOTS // max(d, 1))
    chosen = torch.cat([(cumw[v[lo:lo + per]] <= r[lo:lo + per, None]).sum(1)
                        for lo in range(0, v.numel(), per)]
                       ) if v.numel() else v.clone()
    deg = torch.where(rows >= 0, rows, -1 - rows)[v]
    return chosen, chosen < deg


def _check_lt(nbr, cumw, rows):
    n, d = nbr.shape
    ops.check(cumw, "cumw", torch.float32, (n, d))
    ops.check(rows, "rows", torch.int32, (n,))


def _check_lt_csr(indptr, src, cumw, n: int):
    ops.check(indptr, "indptr", torch.int32, (n + 1,))
    e = src.shape[0] if src.dim() == 1 else -1
    ops.check(src, "src", torch.int32, (e,))
    ops.check(cumw, "cumw", torch.float32, (e,))
    if e >= 2**31:
        raise ValueError(f"{e} edges do not fit int32 row offsets")


def lt_csr_slots(indptr, cumw, v, r):
    """(slot, live) of the LT draws ``r`` at vertices ``v`` over the CSR
    tables (``graphs.csr.lt_reverse``): the count of row ``v``'s sums at
    or below ``r`` (a binary search: they are ascending), live below
    its in-degree."""
    first = indptr[v].long()
    deg = indptr[v + 1].long() - first
    lo, hi = torch.zeros_like(deg), deg.clone()
    for _ in range(int(deg.max()).bit_length() if deg.numel() else 0):
        go = lo < hi
        mid = (lo + hi) // 2
        below = cumw[(first + mid).clamp(max=max(cumw.numel() - 1, 0))] <= r
        lo = torch.where(go & below, mid + 1, lo)
        hi = torch.where(go & ~below, mid, hi)
    return lo, lo < deg


def expand_step_lt_push_plain(words, frontier, visited, indptr, src, cumw,
                              key: Key, next_frontier, next_words,
                              next_count) -> None:
    """The LT push step in plain PyTorch, with the kernel's in-place
    contract (:func:`rrr_expand_push_lt`); the next list comes out
    ascending."""
    n, w_total = frontier.shape
    idx, f = _take(words, frontier)
    live = bitset.unpack_words(f[:, None], bitset.WORD_BITS)
    i, b = torch.nonzero(live, as_tuple=True)          # set bits of each
    v, w = idx[i] // w_total, idx[i] % w_total
    r = key.uniform_at((bitset.WORD_BITS * w + b) * n + v)
    chosen, ok = lt_csr_slots(indptr, cumw, v, r)
    edge = indptr[v[ok]].long() + chosen[ok]
    tgt = src[edge].long() * w_total + w[ok]
    _settle([tgt * bitset.WORD_BITS + b[ok]], idx, visited, next_frontier,
            next_words, next_count)


def rrr_expand_push_lt(words, frontier, visited, indptr, src, cumw,
                       key: Key, next_frontier, next_words,
                       next_count) -> None:
    """One LT sampling step as a push over the live frontier words, in
    place, with :func:`rrr_expand_push_ic`'s contract for ``words``,
    ``frontier``, ``visited``, ``next_frontier``, ``next_words`` and
    ``next_count``.  The reverse adjacency is the graph's CSR: ``indptr``
    int32 [n + 1], ``src`` int32 [nnz] and ``cumw`` float32 [nnz], each
    row's cumulative weights as ``graphs.csr.lt_reverse`` keeps them
    (ascending; no padded table); ``key`` the step's key: sample ``s``
    at vertex ``v`` draws ``uniform(key)[s * n + v]`` and follows the
    edge ``indptr[v] + chosen`` when ``chosen``, the count of the row's
    sums at or below it, is below the in-degree."""
    n, w = frontier.shape
    refuse_wide(n, w, "rrr_expand_lt")
    _check_planes(words, frontier, visited, next_frontier, next_words,
                  next_count)
    _check_lt_csr(indptr, src, cumw, n)
    tensors = (words, frontier, visited, indptr, src, cumw, next_frontier,
               next_words, next_count)
    if not ops.on_card(*tensors):
        return expand_step_lt_push_plain(words, frontier, visited, indptr,
                                         src, cumw, key, next_frontier,
                                         next_words, next_count)
    if words.numel() == 0:
        next_count.zero_()
        return None
    ops.launch("rrr_expand_lt", "rrr_expand", "rrr_expand_lt", _LT_ARGS,
               words.data_ptr(), words.numel(), frontier.data_ptr(),
               visited.data_ptr(), indptr.data_ptr(), src.data_ptr(),
               cumw.data_ptr(), key.k0, key.k1, next_frontier.data_ptr(),
               next_words.data_ptr(), next_count.data_ptr(), n,
               src.shape[0], w)
    return None


def rrr_expand_step_lt(frontier, visited, indptr, src, cumw, key: Key):
    """The dense entry point of the LT push (frontier and visited left
    untouched) -> (new_frontier, new_visited), equal word for word to
    the expansion over the reference's LT selection plane."""
    return _dense_step(
        lambda *planes: rrr_expand_push_lt(planes[0], planes[1], planes[2],
                                           indptr, src, cumw, key,
                                           *planes[3:]),
        frontier, visited)


def cascade_keys(key: Key, n_chunks: int, num_sims: int,
                 device) -> torch.Tensor:
    """The cascade's key table, int32 [n_chunks, num_sims, 2]: entry
    ``[c, s]`` holds the two words of ``fold_in(fold_in(key, c), s)``,
    the reference's per-lane key of chunk ``c`` (each level hashed at
    once in numpy on the host; a CUDA ``device`` gets the table by a
    pinned copy on the current stream)."""
    c = np.arange(n_chunks, dtype=np.int64)
    k0, k1 = prng.threefry2x32(key.k0, key.k1, np.zeros_like(c), c)
    return _sim_keys(k0, k1, num_sims, device)


def lt_cascade_keys(key: Key, num_sims: int, device) -> torch.Tensor:
    """The LT cascade's key table, int32 [num_sims, 2]: row ``s`` holds
    ``fold_in(key, s)``, the reference's key of simulation ``s``."""
    return _sim_keys(np.array([key.k0], np.int64),
                     np.array([key.k1], np.int64), num_sims, device)[0]


def _sim_keys(k0, k1, num_sims: int, device) -> torch.Tensor:
    """int32 [len(k0), num_sims, 2]: ``fold_in((k0[c], k1[c]), s)``."""
    s = np.arange(num_sims, dtype=np.int64)[None]
    y0, y1 = prng.threefry2x32(k0[:, None], k1[:, None], np.zeros_like(s), s)
    table = torch.from_numpy(
        np.stack([y0, y1], -1).astype(np.uint32).view(np.int32))
    device = torch.device(device)
    if device.type == "cuda":
        return table.pin_memory().to(device, non_blocking=True)
    return table.to(device)


def cascade_step_ic_plain(frontier, visited, nbr, prob, keys, chunk: int,
                          num_sims: int, count=None):
    """:func:`cascade_step_ic` in plain PyTorch: per reverse slot, the
    frontier bits that can still become new (simulation lanes not yet
    visited at ``v``) behind a valid slot with ``p > 0``, each hashed at
    its key and draw index through ``prng.threefry2x32``."""
    open_ = bitset.lane_words(num_sims, frontier.device)[None] & ~visited
    kw = keys.to(torch.int64) & prng.M32
    hit = torch.zeros_like(frontier)
    for r in range(nbr.shape[1]):
        u = nbr[:, r].long()
        ok = (u >= 0) & (prob[:, r] > 0)
        f = torch.where(ok[:, None], frontier[u.clamp(min=0)] & open_, 0)
        v, w = torch.nonzero(f, as_tuple=True)
        if v.numel() == 0:
            continue
        live = bitset.unpack_words(f[v, w][:, None], bitset.WORD_BITS)
        i, b = torch.nonzero(live, as_tuple=True)        # set bits of each
        k = kw[r // chunk, bitset.WORD_BITS * w[i] + b]
        idx = v[i] * chunk + r % chunk
        y0, y1 = prng.threefry2x32(k[:, 0], k[:, 1], idx >> 32,
                                   idx & prng.M32)
        fire = prng.float_from_bits(y0 ^ y1) < prob[v[i], r]
        word = torch.zeros(v.numel(), dtype=torch.int64, device=v.device)
        word.index_add_(0, i[fire], torch.ones_like(b[fire]) << b[fire])
        hit[v, w] |= bitset.to_words(word)
    new = hit & ~visited
    if count is not None:
        count.fill_(int((new != 0).sum()))
    return new, visited | new


def step_lanes(d: int) -> int:
    """Threads sharing an output word of ``cascade_ic`` for rows of ``d``
    reverse slots (measured on the H100, ``chip_smoke.py`` phase
    ``timing``): one thread a word on short rows (d = 16 and 128); on
    rows past 512 slots a group of 16, since one lane walks a hub row at
    ~0.15 us a slot (the rmat graph, d = 7,567: ~1.1 ms a step against
    ~0.14 ms for 16 lanes) and a group of 16 costs the short rows ~0.065
    ms a step, so they break even near d = 600."""
    return 16 if d > 512 else 1


def cascade_step_ic(frontier, visited, nbr, prob, keys, chunk: int,
                    num_sims: int, count=None, lanes: int | None = None):
    """One forward IC cascade step with its live edges drawn in the
    step: frontier/visited int32 [n, W], nbr int32 [n, d] (the reverse
    table, valid slots first, -1 after), prob float32 [n, d], keys int32
    [n_chunks, num_sims, 2] (:func:`cascade_keys`, ``n_chunks * chunk >=
    d``) -> (new_frontier, new_visited), equal word for word to
    :func:`rrr_expand_step` over the live-edge plane of those keys.
    ``count`` int32 [1], if given, receives the number of non-zero new
    words.  ``lanes`` (1, 2, ..., 32): the threads that share an output
    word on the card, striding over its slots; None takes
    :func:`step_lanes` of ``d`` (a width is given only to test or time
    the others)."""
    n, w = frontier.shape
    d = nbr.shape[1]
    if lanes is None:
        lanes = step_lanes(d)
    n_chunks = keys.shape[0]
    if n_chunks * chunk < d or chunk < 1:
        raise ValueError(f"{n_chunks} chunk keys x {chunk} slots < d {d}")
    if num_sims < 1 or bitset.num_words(num_sims) != w:
        raise ValueError(f"{num_sims} simulations do not fill {w} words")
    if lanes not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"lanes must be a power of two up to 32, got "
                         f"{lanes}")
    ops.check(frontier, "frontier", torch.int32, (n, w))
    ops.check(visited, "visited", torch.int32, (n, w))
    ops.check(nbr, "nbr", torch.int32, (n, d))
    ops.check(prob, "prob", torch.float32, (n, d))
    ops.check(keys, "keys", torch.int32, (n_chunks, num_sims, 2))
    tensors = (frontier, visited, nbr, prob, keys)
    if count is not None:
        ops.check(count, "count", torch.int32, (1,))
        tensors += (count,)
    if not ops.on_card(*tensors):
        return cascade_step_ic_plain(frontier, visited, nbr, prob, keys,
                                     chunk, num_sims, count)
    newf, viso = torch.empty_like(frontier), torch.empty_like(visited)
    if n * w == 0 or d == 0:
        if count is not None:
            count.zero_()
        return newf.zero_(), viso.copy_(visited)
    ops.launch("cascade_ic", "rrr_expand", "cascade_ic", _CASCADE_ARGS,
               frontier.data_ptr(), visited.data_ptr(), nbr.data_ptr(),
               prob.data_ptr(), keys.data_ptr(), newf.data_ptr(),
               viso.data_ptr(), None if count is None else count.data_ptr(),
               n, d, chunk, n_chunks, w, num_sims, lanes.bit_length() - 1)
    return newf, viso


def cascade_step_lt_plain(frontier, visited, nbr, cumw, rows, keys,
                          num_sims: int, count=None):
    """:func:`cascade_step_lt` in plain PyTorch: the open bits that some
    valid in-neighbour's frontier word holds, each drawn at its key and
    vertex through ``prng.threefry2x32`` and hit iff its live slot's
    frontier word holds the bit."""
    n, w = frontier.shape
    d = nbr.shape[1]
    cand = torch.zeros_like(frontier)
    for r in range(d):
        u = nbr[:, r].long()
        cand |= torch.where((u >= 0)[:, None], frontier[u.clamp(min=0)], 0)
    cand &= bitset.lane_words(num_sims, frontier.device)[None] & ~visited
    v, wi = torch.nonzero(cand, as_tuple=True)
    live = bitset.unpack_words(cand[v, wi][:, None], bitset.WORD_BITS)
    i, b = torch.nonzero(live, as_tuple=True)            # set bits of each
    vi, wb = v[i], wi[i]
    k = keys.to(torch.int64)[bitset.WORD_BITS * wb + b] & prng.M32
    y0, y1 = prng.threefry2x32(k[:, 0], k[:, 1], torch.zeros_like(vi), vi)
    chosen, ok = _lt_slots(cumw, rows, vi, prng.float_from_bits(y0 ^ y1))
    u = nbr[vi, chosen.clamp(max=max(d - 1, 0))].long().clamp(min=0)
    fire = ok & ((frontier[u, wb] >> b) & 1).bool()
    word = torch.zeros(v.numel(), dtype=torch.int64, device=v.device)
    word.index_add_(0, i[fire], torch.ones_like(b[fire]) << b[fire])
    hit = torch.zeros_like(frontier)
    hit[v, wi] = bitset.to_words(word)
    new = hit & ~visited
    if count is not None:
        count.fill_(int((new != 0).sum()))
    return new, visited | new


def cascade_step_lt(frontier, visited, nbr, cumw, rows, keys, num_sims: int,
                    count=None, lanes: int | None = None):
    """One forward LT cascade step with each simulation's live in-edge
    drawn in the step: frontier/visited int32 [n, W], nbr int32 [n, d]
    (the reverse table, valid slots first, -1 after), cumw float32 [n,
    d] and rows int32 [n] its LT tables (:func:`lt_tables`), keys int32
    [num_sims, 2]
    (:func:`lt_cascade_keys`) -> (new_frontier, new_visited), equal word
    for word to :func:`rrr_expand_step` over the LT live-edge plane of
    those keys.  ``count`` and ``lanes`` as :func:`cascade_step_ic`."""
    n, w = frontier.shape
    d = nbr.shape[1]
    if lanes is None:
        lanes = step_lanes(d)
    if num_sims < 1 or bitset.num_words(num_sims) != w:
        raise ValueError(f"{num_sims} simulations do not fill {w} words")
    if lanes not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"lanes must be a power of two up to 32, got "
                         f"{lanes}")
    ops.check(frontier, "frontier", torch.int32, (n, w))
    ops.check(visited, "visited", torch.int32, (n, w))
    ops.check(nbr, "nbr", torch.int32, (n, d))
    _check_lt(nbr, cumw, rows)
    ops.check(keys, "keys", torch.int32, (num_sims, 2))
    tensors = (frontier, visited, nbr, cumw, rows, keys)
    if count is not None:
        ops.check(count, "count", torch.int32, (1,))
        tensors += (count,)
    if not ops.on_card(*tensors):
        return cascade_step_lt_plain(frontier, visited, nbr, cumw, rows,
                                     keys, num_sims, count)
    newf, viso = torch.empty_like(frontier), torch.empty_like(visited)
    if n * w == 0 or d == 0:
        if count is not None:
            count.zero_()
        return newf.zero_(), viso.copy_(visited)
    ops.launch("cascade_lt", "rrr_expand", "cascade_lt", _CASCADE_LT_ARGS,
               frontier.data_ptr(), visited.data_ptr(), nbr.data_ptr(),
               cumw.data_ptr(), rows.data_ptr(), keys.data_ptr(),
               newf.data_ptr(), viso.data_ptr(),
               None if count is None else count.data_ptr(), n, d, w,
               num_sims, lanes.bit_length() - 1)
    return newf, viso
