"""Compressed-sparse-row graph container (twin of ``repro.graphs.csr``).

The graphs are built in numpy on the host, exactly as the reference
builds them from the same seed, and then placed on the requested
device; the padded reverse table is scattered on that device.  The container stores CSR over *incoming* edges:
``indptr[v] .. indptr[v+1]`` indexes the in-neighbors of ``v``.  The LT
push reads no padded table: :func:`lt_reverse` derives its cumulative
weights on the graph's own rows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import resolve_device, span


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Reverse-CSR graph with per-edge probabilities.

    Attributes:
      indptr:  int32 [n + 1]    row pointers (rows = destination vertices)
      indices: int32 [nnz]      in-neighbor (source) vertex of each edge
      probs:   float32 [nnz]    IC activation probability of each edge
      weights: float32 [nnz]    LT edge weight (incoming sums <= 1)
    """
    indptr: torch.Tensor
    indices: torch.Tensor
    probs: torch.Tensor
    weights: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @property
    def num_vertices(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def max_in_degree(self) -> int:
        deg = torch.diff(self.indptr)
        return int(deg.max()) if deg.numel() else 0


def from_arrays(indptr, indices, probs, weights, *, device) -> CSRGraph:
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a).astype(dtype), device=dev)
    return CSRGraph(indptr=put(indptr, np.int32),
                    indices=put(indices, np.int32),
                    probs=put(probs, np.float32),
                    weights=put(weights, np.float32))


def from_edge_list(src: np.ndarray, dst: np.ndarray, n: int,
                   probs: Optional[np.ndarray] = None,
                   seed: int = 0, *, device="cuda") -> CSRGraph:
    """Build the reverse-CSR graph from a directed edge list src -> dst."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    nnz = src.shape[0]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr)
    rng = np.random.default_rng(seed)
    if probs is None:
        # Paper §4.1: uniform random edge probabilities in [0, 0.1].
        probs = rng.uniform(0.0, 0.1, size=nnz).astype(np.float32)
    else:
        probs = np.asarray(probs, dtype=np.float32)[order]
    # LT weights: random, then normalized so each vertex's incoming sum <= 1.
    raw = rng.uniform(0.1, 1.0, size=nnz).astype(np.float64)
    in_deg = np.diff(indptr)
    row_of_edge = np.repeat(np.arange(n), in_deg)
    row_sum = np.zeros(n, dtype=np.float64)
    np.add.at(row_sum, row_of_edge, raw)
    denom = np.maximum(row_sum[row_of_edge], 1e-12)
    weights = (raw / denom).astype(np.float32)
    return from_arrays(indptr, src, probs, weights, device=device)


def to_dense_prob(g: CSRGraph) -> np.ndarray:
    """Dense [n, n] IC probability matrix P[v, u] = p(u -> v), as numpy
    on the host (a later duplicate edge overwrites an earlier one, as
    the reference's loop does).  Test helper."""
    n = g.num_vertices
    indptr, src = _host(g)
    dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dense = np.zeros((n, n), dtype=np.float32)
    dense[dst, src] = g.probs.cpu().numpy()
    return dense


def _host(g: CSRGraph):
    return (g.indptr.cpu().numpy().astype(np.int64),
            g.indices.cpu().numpy().astype(np.int64))


def padded_forward_adjacency(g: CSRGraph, pad_to: Optional[int] = None,
                             rev_pad_to: Optional[int] = None):
    """Padded *forward* adjacency: for each out-edge ``u -> v`` of row
    ``u``, the destination ``v`` and the slot of that edge in ``v``'s
    :func:`padded_adjacency` row (``nbr[v, rev_slot] == u``).

    Returns ``(fwd_nbr, fwd_rslot)`` int32 ``[n, d_out_max]`` on the
    graph's device, padded with ``fwd_nbr = -1`` (``fwd_rslot = 0``).
    The build, in numpy on the host, is the span ``tables.forward``, and
    its copies to the device ``tables.forward.copy`` within it.
    """
    with span("tables.forward"):
        n = g.num_vertices
        indptr, src = _host(g)
        in_deg = np.diff(indptr)
        rev_v = np.repeat(np.arange(n, dtype=np.int64), in_deg)
        rev_slot = np.arange(src.shape[0], dtype=np.int64) - np.repeat(
            indptr[:-1], in_deg)
        if rev_pad_to is not None:
            keep = rev_slot < int(rev_pad_to)
            src, rev_v, rev_slot = src[keep], rev_v[keep], rev_slot[keep]
        order = np.argsort(src, kind="stable")
        src, rev_v, rev_slot = src[order], rev_v[order], rev_slot[order]
        out_deg = (np.bincount(src, minlength=n) if src.size
                   else np.zeros(n, dtype=np.int64))
        df = int(pad_to if pad_to is not None
                 else (out_deg.max() if src.size else 0))
        fwd_nbr = np.full((n, df), -1, dtype=np.int32)
        fwd_rslot = np.zeros((n, df), dtype=np.int32)
        fptr = np.zeros(n + 1, dtype=np.int64)
        fptr[1:] = np.cumsum(out_deg)
        pos = np.arange(src.shape[0], dtype=np.int64) - fptr[src]
        ok = pos < df
        fwd_nbr[src[ok], pos[ok]] = rev_v[ok]
        fwd_rslot[src[ok], pos[ok]] = rev_slot[ok]
        with span("tables.forward.copy"):
            return (torch.from_numpy(fwd_nbr).to(g.device),
                    torch.from_numpy(fwd_rslot).to(g.device))


def padded_adjacency(g: CSRGraph, pad_to: Optional[int] = None):
    """Padded [n, d_max] in-neighbor / prob / weight tables: row v lists
    the in-neighbors of v, padded with -1 (prob/weight 0).  The
    reference fills rows in a per-vertex loop; this scatters every edge
    to its (row, slot) at once, on the graph's device (one host read:
    d_max), with identical output.  The build is the span
    ``tables.reverse``; the scatters it starts may run past its end."""
    with span("tables.reverse"):
        n = g.num_vertices
        dev = g.device
        indptr = g.indptr.long()
        deg = indptr[1:] - indptr[:-1]
        d = int(pad_to if pad_to is not None else (deg.max() if n else 0))
        nbr = torch.full((n, d), -1, dtype=torch.int32, device=dev)
        prob = torch.zeros((n, d), dtype=torch.float32, device=dev)
        wt = torch.zeros((n, d), dtype=torch.float32, device=dev)
        e = g.num_edges
        if n == 0 or d == 0 or e == 0:
            return nbr, prob, wt
        row = torch.repeat_interleave(torch.arange(n, device=dev), deg,
                                      output_size=e)
        slot = torch.arange(e, device=dev) - indptr[row]
        flat = row * d + slot
        if pad_to is not None:
            ok = slot < d
            flat, keep = flat[ok], ok
        else:
            keep = slice(None)
        nbr.view(-1)[flat] = g.indices[keep]
        prob.view(-1)[flat] = g.probs[keep]
        wt.view(-1)[flat] = g.weights[keep]
        return nbr, prob, wt


XLA_BLOCK = 16      # the block of XLA's CPU cumsum (``rrr.xla_cumsum``)


@dataclasses.dataclass(frozen=True)
class LTReverse:
    """The LT push's tables over the reverse CSR, with no [n, d] tensor.

    Attributes:
      indptr: int32 [n + 1]  the graph's row pointers
      src:    int32 [nnz]    the graph's in-neighbour of each edge
      cumw:   float32 [nnz]  row ``v``'s ``deg(v)`` smallest cumulative
              weights of its padded row, ascending (see
              :func:`lt_reverse`)
    """
    indptr: torch.Tensor
    src: torch.Tensor
    cumw: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @property
    def num_vertices(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


def _blocked_levels(x: torch.Tensor, lengths: torch.Tensor):
    """The running sums of each row of the ragged ``x`` (rows of
    ``lengths``, one after another) in XLA's blocked order, as
    ``rrr.xla_cumsum`` gives them on the row padded with zeros to any
    length: sequential within blocks of 16 that start at the row's first
    slot, plus the (recursively blocked) sums of the earlier blocks'
    totals.  A slot's sum does not depend on the padded length (a row of
    at most 16 slots is one block; a zero block adds exactly nothing).
    Returns one ``(sums, lengths)`` a level: level 0 the row's own sums,
    level l + 1 those of level l's block totals, up to the first level
    whose rows are one block each."""
    dev = x.device
    n = lengths.numel()
    blocks = (lengths + XLA_BLOCK - 1) // XLA_BLOCK
    first = torch.cumsum(lengths, 0) - lengths
    bfirst = torch.cumsum(blocks, 0) - blocks
    nb = int(blocks.sum())
    row = torch.repeat_interleave(torch.arange(n, device=dev), lengths,
                                  output_size=x.numel())
    pos = torch.arange(x.numel(), device=dev) - first[row]
    blk, slot = bfirst[row] + pos // XLA_BLOCK, pos % XLA_BLOCK
    buf = torch.zeros((nb, XLA_BLOCK), dtype=x.dtype, device=dev)
    buf[blk, slot] = x
    inner = torch.empty_like(buf)
    acc = torch.zeros(nb, dtype=x.dtype, device=dev)
    for i in range(XLA_BLOCK):
        acc = acc + buf[:, i]
        inner[:, i] = acc
    if not bool((blocks > 1).any()):
        return [(inner[blk, slot], lengths)]
    # block b of a row adds the sum one level up at its block b - 1
    up = _blocked_levels(inner[:, -1].contiguous(), blocks)
    b = torch.arange(nb, device=dev)
    bpos = b - torch.repeat_interleave(bfirst, blocks, output_size=nb)
    carry = torch.where(bpos > 0, up[0][0][(b - 1).clamp(min=0)],
                        torch.zeros_like(acc))
    return [(inner[blk, slot] + carry[blk], lengths)] + up


def _tail_counts(lengths: torch.Tensor, d: int, depth: int) -> torch.Tensor:
    """int64 [depth, n]: how many padded slots ``deg .. d - 1`` of each
    row (deg = ``lengths``) hold the sum of each level's last slot.  A
    padded slot of the block of the row's last slot holds that slot's
    sum (level 0); a slot of a later block holds the carry into its
    block, the sum at block b - 1 one level up, which is, in turn, that
    level's last sum or a later block's carry.  So slot p takes level
    l's last sum where l is the first level at which p's carry index
    falls in the block of that level's last slot; every slot past the
    last level takes its sum (a row of one block adds nothing
    above)."""
    deg = lengths.to(torch.int64)
    out = torch.zeros((depth, deg.numel()), dtype=torch.int64,
                      device=deg.device)
    last = deg - 1
    prev = deg.clamp(max=d)
    for lvl in range(depth):
        if lvl == depth - 1:
            bound = torch.full_like(deg, d)
        else:
            # slots whose carry index at this level is below the end of
            # the block of the level's last slot, mapped back to level 0
            bound = XLA_BLOCK * (last.clamp(min=0) // XLA_BLOCK + 1)
            for _ in range(lvl):
                bound = XLA_BLOCK * (bound + 1)
            bound = bound.clamp(max=d)
        out[lvl] = (bound - prev).clamp(min=0)
        prev = torch.maximum(prev, bound)
        last = last.clamp(min=0) // XLA_BLOCK
    return torch.where(deg > 0, out, 0)


def lt_reverse(g: CSRGraph, pad_to: Optional[int] = None) -> LTReverse:
    """The LT push's tables on the graph's device (span ``tables.lt``).

    The reference counts, for a draw ``r`` at vertex ``v``, the
    cumulative weights at or below ``r`` over ``v``'s whole padded row
    of ``d`` slots (``d`` = ``pad_to``, default the largest in-degree;
    the sums in XLA's blocked order), and the walk follows slot
    ``chosen`` = that count when it is below ``deg(v)``.  That count is
    below ``deg(v)`` exactly when the ``deg(v)``-th smallest of the
    ``d`` sums is above ``r``, and then equals the count over the
    ``deg(v)`` smallest.  So row ``v`` keeps those, ascending, in its
    own CSR slots, and a binary search over them gives ``chosen``.  The
    padded tail holds a few values (each level's blocked sum of the
    whole row; :func:`_tail_counts`), which can sit an ulp below the
    row's largest sum; the rows where one does, or whose sums fall
    somewhere, are merged and sorted, every other row kept as it is."""
    with span("tables.lt"):
        dev = g.device
        indptr = g.indptr.long()
        deg = indptr[1:] - indptr[:-1]
        n, e = g.num_vertices, g.num_edges
        d = int(pad_to if pad_to is not None else (deg.max() if n else 0))
        if pad_to is not None and e and int(deg.max()) > d:
            raise ValueError(f"pad_to={d} is below the largest in-degree "
                             f"{int(deg.max())}")
        if e == 0:
            return LTReverse(g.indptr, g.indices,
                             torch.zeros(0, dtype=torch.float32, device=dev))
        levels = _blocked_levels(g.weights, deg)
        cumw = levels[0][0]
        # each level's last sum of every row, and how many tail slots
        # hold it
        lasts = []
        for sums, lens in levels:
            end = torch.cumsum(lens, 0) - 1
            lasts.append(torch.where(lens > 0, sums[end.clamp(min=0)],
                                     torch.zeros_like(end, dtype=sums.dtype)))
        count = _tail_counts(deg, d, len(levels))
        top = torch.stack(lasts)                       # [depth, n]
        row = torch.repeat_interleave(torch.arange(n, device=dev), deg,
                                      output_size=e)
        big = torch.full((n,), float("-inf"), device=dev).scatter_reduce(
            0, row, cumw, "amax")
        first = indptr[:-1]
        falls = torch.zeros(n, dtype=torch.bool, device=dev)
        drop = cumw[1:] < cumw[:-1]
        same = row[1:] == row[:-1]
        falls[row[1:][drop & same]] = True
        dips = ((count > 0) & (top < big[None])).any(0)
        fix = torch.nonzero(falls | dips)[:, 0]
        if fix.numel():
            cumw = cumw.clone()
            f_deg = deg[fix]
            # the rows' own sums, and each tail value up to deg copies
            f_row = torch.repeat_interleave(torch.arange(
                fix.numel(), device=dev), f_deg)
            f_pos = torch.arange(f_row.numel(), device=dev) - torch.repeat_interleave(
                torch.cumsum(f_deg, 0) - f_deg, f_deg)
            own = cumw[first[fix][f_row] + f_pos]
            reps = torch.minimum(count[:, fix], f_deg[None]).reshape(-1)
            t_row = torch.repeat_interleave(
                torch.arange(fix.numel(), device=dev).repeat(len(levels)),
                reps)
            t_val = torch.repeat_interleave(top[:, fix].reshape(-1), reps)
            vals = torch.cat([own, t_val])
            rows_ = torch.cat([f_row, t_row])
            vals, order = torch.sort(vals, stable=True)
            rows_ = rows_[order]
            rows_, order = torch.sort(rows_, stable=True)
            vals = vals[order]
            sizes = torch.bincount(rows_, minlength=fix.numel())
            rank = torch.arange(rows_.numel(), device=dev) - \
                torch.repeat_interleave(torch.cumsum(sizes, 0) - sizes, sizes)
            keep = rank < f_deg[rows_]
            cumw[first[fix][rows_[keep]] + rank[keep]] = vals[keep]
        return LTReverse(g.indptr, g.indices, cumw.contiguous())
