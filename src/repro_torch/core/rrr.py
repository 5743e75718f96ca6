"""Batched Random-Reverse-Reachable (RRR) set sampling (twin of
``repro.core.rrr``).

Three samplers, bit-identical to the reference's samplers of the same
name and to each other for the same key and ``coin_chunk``:

  * ``sampler="dense"`` — the reference path in plain PyTorch: the
    frontier and visited state of a batch is a bool ``[batch, n]``
    matrix and one expansion scatters over the padded *reverse*
    adjacency, drawing the whole ``[batch, n, chunk]`` coin block (IC)
    or ``[batch, n]`` uniforms (LT) per step, as the reference does.
    It holds a float32 coin block per slot chunk, so it suits small
    graphs only;

and two packed samplers, whose frontier and visited state are
word-packed int32 ``[n, batch/32]`` for the whole BFS, one expansion a
gather over the padded *forward* adjacency: ``hit[u] |= frontier[v] &
mask[v, rev_slot]`` for every forward pair ``(v, rev_slot)`` of ``u``:

  * ``sampler="packed"`` — the plain PyTorch path (coins through
    ``prng``, expansion as tensor gathers);
  * ``sampler="kernel"`` — the step runs as CUDA kernels.  On the
    resident layout (the default; ``gather="auto"`` means resident here,
    there is no VMEM budget to solve for) each step is one kernel,
    ``rrr_expand.rrr_expand_push_ic`` (IC) or ``rrr_expand_push_lt``
    (LT): a push over the list of the frontier's live words along the
    *reverse* adjacency, which draws each coin or live in-edge inside
    the step, updates ``visited`` in place and appends each newly live
    word to the next list once (see ``_push``); it reads no forward
    table, so its callers build none (:func:`reads_forward`), and the LT
    push reads the graph's own CSR rows (``graphs.csr.lt_reverse``), no
    padded table at all (:func:`reads_padded`).  With
    ``gather="streamed"``, IC draws the coin plane (``kernels.coins``)
    and LT builds its selection plane with tensor ops (``_lt_mask``),
    each gathered in one pass into the streamed mask of
    ``rrr_expand_streamed``, which reads only each row's valid slots
    and the frontier's live lines (see ``_planes``).

The per-step mask is the reference's coin / selection mask restricted
to the frontier's live words (the expansion ANDs it with the frontier,
so nothing else is ever read).  That keeps the per-step work
proportional to the frontier instead of to batch * n * d.  The BFS
``while_loop`` becomes a host loop that synchronizes once per step: on
the next list's count (4 bytes) for the push, on the kernel's count of
the new frontier's non-zero lines (4 bytes) for the streamed kernel
path, and on ``frontier.any()`` for the plain path.
"""
from __future__ import annotations

from typing import Literal, Optional

import torch

from repro_torch.core import bitset, span
from repro_torch.core.prng import Key
from repro_torch.graphs.csr import (LTReverse, lt_reverse, padded_adjacency,
                                    padded_forward_adjacency)
from repro_torch.kernels import coins, rrr_expand

Model = Literal["IC", "LT"]

SAMPLERS = ("dense", "packed", "kernel")
GATHERS = ("resident", "streamed", "auto")


def resolve_sampler(sampler: Optional[str], default: str = "kernel") -> str:
    if sampler is None:
        sampler = default
    if sampler not in SAMPLERS:
        raise ValueError(
            f"unknown sampler {sampler!r}; expected one of {SAMPLERS}")
    return sampler


def reads_forward(sampler: str, gather: str = "auto") -> bool:
    """Whether the path of ``(sampler, gather)`` reads the padded forward
    table (``graphs.csr.padded_forward_adjacency``): the plain packed
    path and the kernel path's streamed layout do; the dense sampler and
    the push (``kernel`` on the resident layout) never do, and take
    ``fwd=None``."""
    return sampler == "packed" or (sampler == "kernel"
                                   and gather == "streamed")


def require_fwd(fwd, sampler: str, gather: str, who: str) -> None:
    if fwd is None and reads_forward(sampler, gather):
        raise ValueError(f"{who} needs fwd=(fwd_nbr, fwd_rslot) from "
                         "graphs.csr.padded_forward_adjacency")


def reads_padded(sampler: str, gather: str = "auto",
                 model: str = "IC") -> bool:
    """Whether the path of ``(sampler, gather, model)`` reads the padded
    reverse tables (``graphs.csr.padded_adjacency``): every path but the
    LT push (``kernel`` on the resident layout under LT), which reads
    the graph's CSR through ``graphs.csr.lt_reverse`` and takes
    ``nbr = prob = wt = None`` with ``lt=``."""
    return not (sampler == "kernel" and gather != "streamed"
                and model == "LT")


def graph_tables(g, sampler: str, gather: str = "auto", model: str = "IC"):
    """The tables the sampler path reads, built for graph ``g`` and
    nothing else: ``(nbr, prob, wt, fwd, lt)`` with the padded reverse
    tables where :func:`reads_padded` holds (else None each), the padded
    forward table where :func:`reads_forward` holds (else None), and the
    LT push's CSR tables (:class:`graphs.csr.LTReverse`) where the path
    is that push (else None)."""
    sampler = resolve_sampler(sampler)
    padded = reads_padded(sampler, gather, model)
    nbr, prob, wt = padded_adjacency(g) if padded else (None, None, None)
    fwd = (padded_forward_adjacency(g) if reads_forward(sampler, gather)
           else None)
    return nbr, prob, wt, fwd, (None if padded else lt_reverse(g))


def lt_reverse_padded(nbr, wt) -> LTReverse:
    """The LT push's CSR tables from padded reverse tables ``nbr`` int32
    and ``wt`` float32 [n, d] (valid slots first): each row's sums over
    its d slots in XLA's blocked order, sorted, the first ``deg`` kept
    (what ``graphs.csr.lt_reverse`` computes without the [n, d]
    tables)."""
    valid = nbr >= 0
    deg = valid.sum(1)
    indptr = torch.zeros(nbr.shape[0] + 1, dtype=torch.int64,
                         device=nbr.device)
    indptr[1:] = torch.cumsum(deg, 0)
    cumw = xla_cumsum(wt).sort(1).values if nbr.shape[1] else wt
    return LTReverse(indptr.to(torch.int32), nbr[valid].contiguous(),
                     cumw[valid].contiguous())


def _device(nbr, lt):
    return nbr.device if nbr is not None else lt.device


def _coin_chunks(d: int, coin_chunk: int):
    """(chunk, n_chunks, d_pad) of the degree-chunked coin draw."""
    if coin_chunk < 1:
        raise ValueError(f"coin_chunk must be >= 1, got {coin_chunk}")
    chunk = min(d, coin_chunk)
    n_chunks = (d + chunk - 1) // chunk
    return chunk, n_chunks, n_chunks * chunk


def xla_cumsum(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """float32 cumulative sum along the last axis in the order XLA's CPU
    backend sums ``jnp.cumsum``: sequential within blocks of ``base``,
    plus the sequential (recursively blocked) sum of the earlier blocks'
    totals.  ``torch.cumsum`` accumulates differently, and LT sampling
    compares uniforms against these sums bit for bit."""
    d = x.shape[-1]
    if d <= base:
        out = torch.empty_like(x)
        acc = torch.zeros_like(x[..., 0])
        for i in range(d):
            acc = acc + x[..., i]
            out[..., i] = acc
        return out
    nb = -(-d // base)
    xp = torch.nn.functional.pad(x, (0, nb * base - d))
    inner = xla_cumsum(xp.reshape(*x.shape[:-1], nb, base), base)
    totals = xla_cumsum(inner[..., -1], base)
    carry = torch.nn.functional.pad(totals[..., :-1], (1, 0))
    return (inner + carry[..., None]).reshape(*x.shape[:-1],
                                              nb * base)[..., :d]


def packed_roots(roots: torch.Tensor, n: int) -> torch.Tensor:
    """Packed root incidence: bit i of word i//32 set at row roots[i]
    (a scatter-add of distinct bits, so add == OR when roots repeat)."""
    batch = roots.shape[0]
    w = bitset.num_words(batch)
    i = torch.arange(batch, device=roots.device)
    out = torch.zeros(n * w, dtype=torch.int32, device=roots.device)
    contrib = bitset.to_words(torch.ones_like(i) << (i % bitset.WORD_BITS))
    out.index_put_((roots.long() * w + i // bitset.WORD_BITS,), contrib,
                   accumulate=True)
    return out.reshape(n, w)


def root_words(roots: torch.Tensor, w: int) -> torch.Tensor:
    """The push's first word list: the distinct flat indices
    ``roots[i] * w + i // 32`` (the non-zero words of
    :func:`packed_roots`), ascending, int32."""
    i = torch.arange(roots.shape[0], device=roots.device)
    return torch.unique(roots.long() * w + i // bitset.WORD_BITS
                        ).to(torch.int32)


def root_lines(roots: torch.Tensor, n: int, w: int) -> torch.Tensor:
    """The line summary of :func:`packed_roots` (``rrr_expand
    .line_summary``): byte ``(roots[i], i // 1024)`` set, uint8 [n,
    ceil(w / 32)]."""
    lines = rrr_expand.num_lines(w)
    out = torch.zeros(n * lines, dtype=torch.uint8, device=roots.device)
    i = torch.arange(roots.shape[0], device=roots.device)
    out[roots.long() * lines
        + i // (bitset.WORD_BITS * rrr_expand.LINE_WORDS)] = 1
    return out.reshape(n, lines)


def _live_bits(frontier: torch.Tensor):
    """(sample, vertex, word) of every set frontier bit."""
    v, w = torch.nonzero(frontier, as_tuple=True)
    live = bitset.unpack_words(frontier[v, w][:, None], bitset.WORD_BITS)
    p, bit = torch.nonzero(live, as_tuple=True)
    return bitset.WORD_BITS * w[p] + bit, v[p], w[p]


class _Tables:
    """Per-graph tables of one sampling call, built once.  ``forward``
    says whether the path reads the forward gathers; the LT push
    (``lt`` given, or derived from ``nbr`` and ``wt``) reads only the
    CSR tables ``self.lt``."""

    def __init__(self, nbr, prob, wt, fwd_nbr, fwd_rslot, *, model: str,
                 coin_chunk: int, forward: bool = True,
                 lt: Optional[LTReverse] = None):
        if model not in ("IC", "LT"):
            raise ValueError(f"unknown model {model!r}; expected IC or LT")
        if model == "LT" and not forward:   # the push: no padded table
            self.lt = lt if lt is not None else lt_reverse_padded(nbr, wt)
            self.n = self.lt.num_vertices
            return
        n, d = nbr.shape
        self.n, self.d = n, d
        self.nbr = nbr
        self.chunk, self.n_chunks, self.d_pad = _coin_chunks(d, coin_chunk)
        if forward:     # the forward gathers; the push reads nbr only
            valid = fwd_nbr >= 0
            self.nbr_c = torch.where(valid, fwd_nbr, 0).contiguous()
            self.gidx = torch.where(
                valid, self.nbr_c * self.d_pad + fwd_rslot.clamp(min=0),
                n * self.d_pad).to(torch.int32).contiguous()
            self.rslot = fwd_rslot.clamp(min=0).long()
            self.valid = valid
            # the kernel's per-row count of valid slots (valid slots come
            # first), and the streamed gather's plane rows: gidx at valid
            # slots, row 0 past them (never read by the kernel)
            self.slots = valid.sum(1, dtype=torch.int32)
            self.take = torch.where(valid, self.gidx, 0).reshape(-1)
        if model == "IC":
            self.prob_p = torch.nn.functional.pad(
                prob, (0, self.d_pad - d)).contiguous()
        else:
            # rows ascending (rrr_expand.lt_tables): every count of
            # sums at or below a draw is the reference's
            self.cumw, self.lt_rows = rrr_expand.lt_tables(nbr,
                                                           xla_cumsum(wt))
            self.in_deg = (nbr >= 0).sum(1)


def _ic_mask(t: _Tables, sub: Key, frontier, kernel: bool):
    keys = [sub.fold_in(c) for c in range(t.n_chunks)]
    fn = coins.coin_plane if kernel else coins.coin_plane_plain
    return fn(keys, t.prob_p, frontier, t.chunk)


def _lt_mask(t: _Tables, sub: Key, frontier):
    """LT live-edge selection mask: each (sample, vertex) selects the
    first slot j with r < cumw[v, j] (none when j reaches the degree),
    r = uniform(sub, (batch, n))[sample, vertex].  Built only at the
    frontier's set bits, as a scatter of distinct bits."""
    n, d_pad = t.n, t.d_pad
    w_total = frontier.shape[1]
    plane = torch.zeros(n * d_pad * w_total, dtype=torch.int32,
                        device=frontier.device)
    b, v, w = _live_bits(frontier)
    r = sub.uniform_at(b * n + v)
    chosen = (t.cumw[v] <= r[:, None]).sum(1)
    ok = chosen < t.in_deg[v]
    bit = bitset.to_words(torch.ones_like(b[ok]) << (b[ok] % 32))
    plane.index_put_(((v[ok] * d_pad + chosen[ok]) * w_total + w[ok],), bit,
                     accumulate=True)
    return plane.reshape(n, d_pad, w_total)


def _step(t: _Tables, sub: Key, frontier, visited, model: str):
    """One step of the plain path: the model's plane, gathered with its
    invalid slots zeroed, and the plain expansion."""
    mask = (_ic_mask(t, sub, frontier, False) if model == "IC"
            else _lt_mask(t, sub, frontier))
    gmask = torch.where(t.valid[:, :, None], mask[t.nbr_c.long(), t.rslot], 0)
    return rrr_expand.expand_step_plain(frontier, visited, t.nbr_c, gmask)


def _planes(t: _Tables, roots, key: Key, visited, max_steps: int,
            model: str):
    """The BFS on the streamed layout's kernels; returns (steps, visited).
    Each step draws the model's plane, gathers it into ``[n, df, W]`` in
    one pass (rows ``t.take`` of the plane: no copy zeroes the invalid
    slots, which the kernel, given ``t.slots``, never reads) and expands
    it with ``rrr_expand_streamed``, which reads only the frontier lines
    the summary marks live and writes the next summary and the count of
    the new frontier's non-zero lines.  The first summary comes from the
    roots; the loop stops when the count is 0."""
    n, w = visited.shape
    frontier = visited
    lines = root_lines(roots, n, w)
    spare = torch.empty_like(lines)
    count = torch.zeros(1, dtype=torch.int32, device=visited.device)
    step = 0
    go = roots.numel() > 0
    while go and step < max_steps:
        with span("rrr.step"):
            key, sub = key.split()
            mask = (_ic_mask(t, sub, frontier, True) if model == "IC"
                    else _lt_mask(t, sub, frontier))
            gmask = mask.view(n * t.d_pad, w).index_select(0, t.take)
            del mask
            frontier, visited = rrr_expand.rrr_expand_step(
                frontier, visited, t.nbr_c, gmask.view(n, -1, w),
                slots=t.slots, lines=lines, next_lines=spare, count=count)
            del gmask
            lines, spare = spare, lines
            step += 1
            go = bool(int(count))
    return step, visited


def _push_ic(t: _Tables, sub: Key, *planes) -> None:
    keys = [sub.fold_in(c) for c in range(t.n_chunks)]
    rrr_expand.rrr_expand_push_ic(*planes[:3], t.nbr, t.prob_p, keys,
                                  t.chunk, *planes[3:])


def _push_lt(t: _Tables, sub: Key, *planes) -> None:
    rrr_expand.rrr_expand_push_lt(*planes[:3], t.lt.indptr, t.lt.src,
                                  t.lt.cumw, sub, *planes[3:])


_PUSH = {"IC": _push_ic, "LT": _push_lt}


class _LTTally:
    """The LT push's counters, read once a sampling call: the live bits
    the steps draw (``frontier_bits``; the roots' are ``root_bits``, one
    a sample), and the cumulative weights their searches read
    (``choice_reads``: ceil(log2 deg) + 1 a draw, at most the row's
    ``deg`` sums a step).  A step keeps its list and its frontier words
    (two launches); the counts are taken over all steps at the end."""

    def __init__(self, lt: LTReverse, w: int, samples: int):
        self.lt, self.w, self.samples = lt, w, samples
        self.words, self.values = [], []

    def step(self, words, frontier) -> None:
        self.words.append(words.clone())
        self.values.append(frontier.view(-1).index_select(0, words))

    def add_to(self, stats: dict) -> None:
        n = self.lt.num_vertices
        dev = self.lt.device
        sizes = torch.tensor([x.numel() for x in self.words], device=dev)
        step = torch.repeat_interleave(torch.arange(len(self.words),
                                                    device=dev), sizes)
        bits = bitset.popcount(torch.cat(self.values)).long()
        code = step * n + torch.cat(self.words).long() // self.w
        rows, inv = torch.unique(code, return_inverse=True)
        draws = torch.zeros(rows.shape, dtype=torch.int64,
                            device=dev).index_add_(0, inv, bits)
        rows = rows % n
        deg = (self.lt.indptr[rows + 1] - self.lt.indptr[rows]).long()
        # ceil(log2 deg) + 1: the bit length of deg - 1, plus one
        per_draw = torch.ones_like(deg)
        rest = (deg - 1).clamp(min=0)
        for _ in range(int(rest.max()).bit_length() if rest.numel() else 0):
            per_draw += rest > 0
            rest = rest >> 1
        reads = torch.minimum(draws * per_draw, deg).sum()
        for name, v in (("frontier_bits", int(bits.sum())),
                        ("choice_reads", int(reads)),
                        ("root_bits", self.samples)):
            stats[name] = stats.get(name, 0) + v


def _push(t: _Tables, roots, key: Key, visited, max_steps: int,
          model: str, stats: Optional[dict] = None) -> tuple[int, int]:
    """The BFS as pushes over word lists (the model's step kernel from
    ``_PUSH``), ``visited`` updated in place; returns the steps taken
    and the words the steps' lists held (the roots' first).  Two
    frontier planes ping-pong (a step zeroes the words it reads,
    leaving its plane zero for the step after) and two word lists
    alternate; each step's one host sync reads the next list's count,
    and the loop ends when it is 0.  No step passes over a whole [n, W]
    plane.  Each step is the span ``rrr.step``, which ends on that
    read.  With ``stats``, the LT push adds its counters
    (:class:`_LTTally`), kept outside the steps' spans and counted once
    at the end."""
    push = _PUSH[model]
    n, w = visited.shape
    dev = visited.device
    frontier, spare = visited.clone(), torch.zeros_like(visited)
    lists = [torch.empty(n * w, dtype=torch.int32, device=dev)
             for _ in range(2)]
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    words = root_words(roots, w)
    tally = (_LTTally(t.lt, w, roots.numel())
             if stats is not None and model == "LT" else None)
    step = listed = 0
    while step < max_steps and words.numel():
        if tally is not None:
            tally.step(words, frontier)
        with span("rrr.step"):
            key, sub = key.split()
            out = lists[step % 2]
            listed += words.numel()
            push(t, sub, words, frontier, visited, spare, out, count)
            words = out[:int(count)]
            frontier, spare = spare, frontier
            step += 1
    if tally is not None:
        tally.add_to(stats)
    return step, listed


def rrr_batch_packed(nbr, prob, wt, fwd_nbr, fwd_rslot, roots, key: Key, *,
                     model: str, max_steps: int = 64, coin_chunk: int = 32,
                     expand: str = "plain", gather: str = "auto",
                     stats: Optional[dict] = None,
                     lt: Optional[LTReverse] = None):
    """Packed-state RRR batch -> int32 [n, ceil(batch/32)]: bit i of word
    i//32 at row v is set iff v in RRR(roots[i]).  ``expand`` is "plain"
    (PyTorch coins and gathers) or "kernel" (the CUDA kernels).
    ``fwd_nbr`` and ``fwd_rslot`` may be None where :func:`reads_forward`
    is false: the push never reads them.  The LT push reads ``lt``
    (``graphs.csr.lt_reverse``; derived from ``nbr`` and ``wt`` when
    None), and ``nbr``, ``prob`` and ``wt`` may then be None
    (:func:`reads_padded`).  ``stats`` (optional dict) accumulates
    ``bfs_steps`` and, on the push (``expand="kernel"``, resident),
    ``frontier_words``: the words of the live-word lists its steps
    pushed, the roots' included; the LT push adds ``frontier_bits``,
    ``root_bits`` and ``choice_reads`` (``_LTTally``).  The call's
    tables are the span ``rrr.tables``, each BFS step the span
    ``rrr.step``."""
    if expand not in ("plain", "kernel"):
        raise ValueError(f"expand must be 'plain' or 'kernel', got {expand!r}")
    if gather not in GATHERS:
        raise ValueError(f"unknown gather {gather!r}; expected {GATHERS}")
    kernel = expand == "kernel"
    sampler = "kernel" if kernel else "packed"
    forward = reads_forward(sampler, gather)
    if reads_padded(sampler, gather, model):
        n, d = nbr.shape
    elif lt is None and nbr is None:
        raise ValueError("the LT push needs lt= (graphs.csr.lt_reverse) "
                         "or the padded tables")
    else:
        n = lt.num_vertices if lt is not None else nbr.shape[0]
        d = lt.num_edges if lt is not None else nbr.shape[1]
    visited = packed_roots(roots, n)
    if d == 0:          # edgeless graph: RRR(root) = {root}
        return visited
    with span("rrr.tables"):
        t = _Tables(nbr, prob, wt, fwd_nbr, fwd_rslot, model=model,
                    coin_chunk=coin_chunk, forward=forward, lt=lt)
    listed = None
    if not forward:
        step, listed = _push(t, roots, key, visited, max_steps, model,
                             stats)
    elif kernel:
        step, visited = _planes(t, roots, key, visited, max_steps, model)
    else:
        frontier = visited
        step = 0
        while step < max_steps and bool(frontier.any()):
            with span("rrr.step"):
                key, sub = key.split()
                frontier, visited = _step(t, sub, frontier, visited, model)
                step += 1
    if stats is not None:
        stats["bfs_steps"] = stats.get("bfs_steps", 0) + step
        if listed is not None:
            stats["frontier_words"] = stats.get("frontier_words",
                                                0) + listed
    return visited


def _rrr_batch_dense(nbr, prob, wt, roots, key: Key, *, model: str,
                     max_steps: int, coin_chunk: int,
                     stats: Optional[dict] = None) -> torch.Tensor:
    """The reference's dense BFS: bool [batch, n] state, one scatter over
    the padded reverse adjacency per step (column n is the sink of the
    padded slots)."""
    n, d = nbr.shape
    batch = roots.shape[0]
    dev = nbr.device
    visited = torch.zeros((batch, n), dtype=torch.bool, device=dev)
    visited[torch.arange(batch, device=dev), roots.long()] = True
    if d == 0:          # edgeless graph: RRR(root) = {root}
        return visited
    valid = nbr >= 0
    if model == "IC":
        chunk, n_chunks, d_pad = _coin_chunks(d, coin_chunk)
        prob_p = torch.nn.functional.pad(prob, (0, d_pad - d))
        tgt_p = torch.nn.functional.pad(torch.where(valid, nbr, n),
                                        (0, d_pad - d), value=n).long()
    elif model == "LT":
        cumw = xla_cumsum(wt)
        in_deg = valid.sum(1)
        rows = torch.arange(n, device=dev)[None, :]
    else:
        raise ValueError(f"unknown model {model!r}; expected IC or LT")
    frontier = visited
    step = 0
    while step < max_steps and bool(frontier.any()):
        key, sub = key.split()
        hit = torch.zeros((batch, n + 1), dtype=torch.bool, device=dev)
        if model == "IC":
            for c in range(n_chunks):
                # v in the frontier examines in-edge (u -> v): with
                # probability p the reverse traversal reaches u.
                coins_c = sub.fold_in(c).uniform((batch, n, chunk),
                                                 device=dev)
                fire = frontier[:, :, None] & (
                    coins_c < prob_p[None, :, c * chunk:(c + 1) * chunk])
                b, v, j = torch.nonzero(fire, as_tuple=True)
                hit[b, tgt_p[v, c * chunk + j]] = True
        else:  # LT live edge: v follows in-edge j with probability wt[v, j]
            r = sub.uniform((batch, n), device=dev)
            chosen = (r[:, :, None] >= cumw[None]).sum(-1)
            pick_nbr = nbr[rows, chosen.clamp(0, d - 1)]
            go = frontier & (chosen < in_deg[None]) & (pick_nbr >= 0)
            b, v = torch.nonzero(go, as_tuple=True)
            hit[b, pick_nbr[b, v].long()] = True
        new = hit[:, :n] & ~visited
        frontier, visited = new, visited | new
        step += 1
    if stats is not None:
        stats["bfs_steps"] = stats.get("bfs_steps", 0) + step
    return visited


def rrr_batch(nbr, prob, wt, roots, key: Key, *, model: str,
              max_steps: int = 64, sampler: str = "dense", fwd=None,
              coin_chunk: int = 32, gather: str = "auto",
              stats: Optional[dict] = None,
              lt: Optional[LTReverse] = None) -> torch.Tensor:
    """One batch of RRR sets as bool [batch, n]: ``visited[i, v]`` iff v
    is in RRR(roots[i]).  The packed samplers return their words
    unpacked; where :func:`reads_forward` holds they need ``fwd=(fwd_nbr,
    fwd_rslot)``, and the LT push takes ``lt`` in place of the padded
    tables (:func:`rrr_batch_packed`)."""
    sampler = resolve_sampler(sampler, default="dense")
    if sampler == "dense":
        return _rrr_batch_dense(nbr, prob, wt, roots, key, model=model,
                                max_steps=max_steps, coin_chunk=coin_chunk,
                                stats=stats)
    require_fwd(fwd, sampler, gather, f"sampler={sampler!r}")
    fwd = (None, None) if fwd is None else fwd
    packed = rrr_batch_packed(
        nbr, prob, wt, fwd[0], fwd[1], roots, key, model=model,
        max_steps=max_steps, coin_chunk=coin_chunk,
        expand=("kernel" if sampler == "kernel" else "plain"), gather=gather,
        stats=stats, lt=lt)
    return bitset.unpack_words(packed, roots.shape[0]).T


def sample_incidence(nbr, prob, wt, key: Key, *, theta: int, n: int,
                     model: str, max_steps: int = 64,
                     sampler: str = "kernel", fwd=None, coin_chunk: int = 32,
                     gather: str = "auto", stats: Optional[dict] = None,
                     lt: Optional[LTReverse] = None):
    """Sample ``theta`` RRR sets (theta a multiple of 32); return the
    packed incidence X int32 [n, theta/32] on the tables' device.  The
    paths :func:`reads_forward` names need ``fwd``; the LT push reads
    ``lt`` (``nbr``, ``prob`` and ``wt`` may then be None); the dense one
    packs its [theta, n] bool state at the end, as the reference does.
    The call is the span ``rrr.sample``; ``stats`` (optional dict)
    accumulates the sampler's counters (:func:`rrr_batch_packed`)."""
    if theta % bitset.WORD_BITS:
        raise ValueError(f"theta must be a multiple of 32, got {theta}")
    sampler = resolve_sampler(sampler)
    require_fwd(fwd, sampler, gather, "sample_incidence")
    fwd = (None, None) if fwd is None else fwd
    kr, kb = key.split()
    with span("rrr.sample"):
        roots = kr.randint((theta,), 0, n, device=_device(nbr, lt))
        if sampler == "dense":
            visited = _rrr_batch_dense(nbr, prob, wt, roots, kb, model=model,
                                       max_steps=max_steps,
                                       coin_chunk=coin_chunk, stats=stats)
            return bitset.pack_bool_matrix(visited.T)
        return rrr_batch_packed(
            nbr, prob, wt, fwd[0], fwd[1], roots, kb, model=model,
            max_steps=max_steps, coin_chunk=coin_chunk,
            expand=("kernel" if sampler == "kernel" else "plain"),
            gather=gather, stats=stats, lt=lt)


def sample_incidence_host(g, theta: int, key: Key, model: str = "IC",
                          max_steps: int = 64, batch: int = 256,
                          sampler: str = "kernel", coin_chunk: int = 32,
                          gather: str = "auto"):
    """``theta`` samples drawn in batches of ``batch`` (batch i keyed
    ``key.fold_in(i)``) to bound peak memory.  ``theta`` rounds up to
    whole words; returns (X int32 [n, theta/32] on the graph's device,
    the rounded theta)."""
    sampler = resolve_sampler(sampler)
    theta = bitset.num_words(theta) * bitset.WORD_BITS
    nbr, prob, wt, fwd, lt = graph_tables(g, sampler, gather, model)
    n = g.num_vertices
    chunks = []
    done = i = 0
    while done < theta:
        b = bitset.num_words(min(batch, theta - done)) * bitset.WORD_BITS
        chunks.append(sample_incidence(
            nbr, prob, wt, key.fold_in(i), theta=b, n=n, model=model,
            max_steps=max_steps, sampler=sampler, fwd=fwd,
            coin_chunk=coin_chunk, gather=gather, lt=lt))
        done += b
        i += 1
    x = torch.cat(chunks, 1)[:, :bitset.num_words(theta)]
    return x, theta
