"""RRR sets over the reverse CSR, with no [n, d] table: the samples
``sampler.py`` draws, for graphs whose rows padded to the largest
in-degree ``d`` would not fit a card.

IC reads each row's own in-edges and probabilities (``sampler``'s IC
step, unchanged).  LT needs, for a draw ``r`` at vertex ``v``, the
number of the padded row's ``d`` cumulative weights at or below ``r``
(summed in XLA's blocked order with the padded slots adding 0).  So
every row is summed as ``sampler.xla_cumsum`` sums it, padded to ``d``,
a block of rows at a time (at most ``BLOCK`` sums held at once), and of
each row three things are kept:

* its ``deg`` own sums, in the CSR's order (float32 [nnz]);
* whether they fall somewhere (a later sum below an earlier one);
* the distinct values of its padded tail below its largest own sum,
  each with the number of tail slots that hold it.  A tail slot's sum
  is a blocked sum of the whole row, which can round an ulp below the
  row's last sum; a tail value at or above the largest own sum can only
  count where every own sum does, when no in-edge is live anyway.

A draw then takes ``chosen`` = the own sums at or below ``r`` (a binary
search where they never fall, a count elsewhere) plus the tail slots
at or below ``r``, and follows in-edge ``chosen`` if it is below the
in-degree.  ``precision="bfloat16"`` rounds the sums, the tail values
and the uniforms before comparing, as ``sampler`` does (the control).
"""
from __future__ import annotations

import torch

from portbench.reference import sampler
from portbench.reference.threefry import Key

# sums of padded rows held at once while the tables are built
BLOCK = 1 << 24


class Graph(sampler.Graph):
    """The reverse CSR on a device, with the LT tables built from it a
    block of rows at a time.  It holds no [n, d] table: ``cumw`` is
    refused."""

    def __init__(self, indptr, indices, probs, weights, *, device):
        super().__init__(indptr, indices, probs, weights, device=device)
        self._lt = None

    def cumw(self) -> torch.Tensor:
        raise RuntimeError("the CSR reference holds no padded table")

    def lt_tables(self):
        """(own sums float32 [nnz], falls bool [n], tail values float32
        [t, K], tail counts int64 [t, K], each row's tail index int64 [n]
        or -1): see the module's description."""
        if self._lt is None:
            self._lt = _build(self)
        return self._lt


def _build(g: Graph):
    dev, n, d = g.device, g.n, max(g.d, 1)
    sums = torch.zeros(g.src.numel(), dtype=torch.float32, device=dev)
    falls = torch.zeros(n, dtype=torch.bool, device=dev)
    tails = []                               # (row, values, counts)
    rows = torch.nonzero(g.deg > 0)[:, 0]
    step = max(1, BLOCK // d)
    slot = torch.arange(d, device=dev)
    for lo in range(0, rows.numel(), step):
        part = rows[lo:lo + step]
        deg = g.deg[part]
        own = slot[None] < deg[:, None]
        r, s = torch.nonzero(own, as_tuple=True)
        edge = g.indptr[part][r] + s
        wt = torch.zeros((part.numel(), d), dtype=torch.float32, device=dev)
        wt[r, s] = g.weights[edge]
        cw = sampler.xla_cumsum(wt)
        sums[edge] = cw[r, s]
        falls[part] = ((cw[:, 1:] < cw[:, :-1]) & own[:, 1:]).any(1)
        big = torch.where(own, cw, float("-inf")).max(1).values
        below = ~own & (cw < big[:, None])
        for i in torch.nonzero(below.any(1))[:, 0].tolist():
            vals, counts = torch.unique(cw[i][below[i]], return_counts=True)
            tails.append((int(part[i]), vals, counts))
    width = max((v.numel() for _, v, _ in tails), default=1)
    t_val = torch.full((max(len(tails), 1), width), float("inf"),
                       device=dev)
    t_cnt = torch.zeros(t_val.shape, dtype=torch.int64, device=dev)
    t_row = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for j, (v, vals, counts) in enumerate(tails):
        t_val[j, :vals.numel()] = vals
        t_cnt[j, :vals.numel()] = counts
        t_row[v] = j
    return sums, falls, t_val, t_cnt, t_row


def _lt_hits(g: Graph, sub: Key, b, v, precision: str):
    """(frontier entry, source) of the in-edge each frontier entry
    (sample b, vertex v) follows, by the count over the padded row."""
    sums, falls, t_val, t_cnt, t_row = g.lt_tables()
    r = sampler._round(sub.uniform_at(b * g.n + v), precision)
    sums = sampler._round(sums, precision)
    first, deg = g.indptr[v], g.deg[v]
    chosen = torch.zeros(v.shape, dtype=torch.int64, device=g.device)
    # own sums that never fall: the first whose sum is above r
    at = torch.nonzero(~falls[v])[:, 0]
    lo = torch.zeros(at.shape, dtype=torch.int64, device=g.device)
    hi = deg[at].clone()
    base, rr = first[at], r[at]
    while bool((lo < hi).any()):
        mid = (lo + hi) // 2
        below = sums[(base + mid).clamp(max=max(sums.numel() - 1, 0))] <= rr
        go = lo < hi
        lo = torch.where(go & below, mid + 1, lo)
        hi = torch.where(go & ~below, mid, hi)
    chosen[at] = lo
    # own sums that fall: counted
    for i in torch.nonzero(falls[v])[:, 0].tolist():
        row = sums[first[i]:first[i] + deg[i]]
        chosen[i] = int((row <= r[i]).sum())
    # the tail slots at or below r
    has = torch.nonzero(t_row[v] >= 0)[:, 0]
    if has.numel():
        j = t_row[v[has]]
        vals = sampler._round(t_val[j], precision)
        chosen[has] += (t_cnt[j] * (vals <= r[has, None])).sum(1)
    ok = chosen < deg
    edge = first[ok] + chosen[ok]
    return torch.nonzero(ok)[:, 0], g.src[edge]


def rrr_sets(g: Graph, kc: Key, cols: torch.Tensor, *, model: str,
             max_steps: int, precision: str = "float32"):
    """The RRR sets of samples ``cols`` (int64, distinct) of a draw under
    ``kc``, as pairs (position in ``cols``, vertex): ``sampler.rrr_sets``
    with the LT step above."""
    cols = cols.to(device=g.device, dtype=torch.int64)
    hits = {"IC": sampler._ic_hits, "LT": _lt_hits}[model]
    c = cols.numel()
    pos = torch.arange(c, device=g.device)
    front_v = sampler.roots(g, kc, cols)
    front_b = pos
    visited = torch.zeros((c, g.n), dtype=torch.bool, device=g.device)
    visited[front_b, front_v] = True
    out_b, out_v = [front_b], [front_v]
    key = kc.split()[1]
    step = 0
    while step < max_steps and front_v.numel():
        key, sub = key.split()
        entry, hu = hits(g, sub, cols[front_b], front_v, precision)
        hb = front_b[entry]
        code = torch.unique(hb * g.n + hu)
        hb, hu = code // g.n, code % g.n
        new = ~visited[hb, hu]
        front_b, front_v = hb[new], hu[new]
        visited[front_b, front_v] = True
        out_b.append(front_b)
        out_v.append(front_v)
        step += 1
    return torch.cat(out_b), torch.cat(out_v)


def draw(g: Graph, kc: Key, cols: torch.Tensor, *, model: str,
         max_steps: int, precision: str = "float32", block: int = 0):
    """:func:`rrr_sets` over ``cols`` sorted, in pieces of ``block``
    samples (0: as many as a 2**31-entry visited table holds), as pairs
    (sample index in the draw, vertex)."""
    cols = torch.sort(cols.to(device=g.device, dtype=torch.int64)).values
    block = block or max(1, (1 << 31) // max(g.n, 1))
    out_b, out_v = [], []
    for lo in range(0, cols.numel(), block):
        part = cols[lo:lo + block]
        b, v = rrr_sets(g, kc, part, model=model, max_steps=max_steps,
                        precision=precision)
        out_b.append(part[b])
        out_v.append(v)
    if not out_b:
        empty = torch.zeros(0, dtype=torch.int64, device=g.device)
        return empty, empty
    return torch.cat(out_b), torch.cat(out_v)


roots = sampler.roots
