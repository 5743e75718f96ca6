"""Random reverse-reachable (RRR) sets, one sample at a time, in plain
PyTorch.

Sample ``b`` of a draw of ``count`` samples under key ``kc`` is the set
of vertices that reach its root ``randint(kr, count)[b]`` (``kr, kb =
kc.split()``) in a live-edge graph drawn step by step: step ``s`` takes
``key, sub = key.split()`` from ``key = kb`` and

* IC: each frontier vertex ``v`` examines each in-edge ``j`` (its
  ``j``-th in the graph's row order) and reaches its source when the
  uniform of key ``sub.fold_in(j // chunk)`` at flat index ``(b * n +
  v) * chunk + j % chunk`` lies below the edge's probability, where
  ``chunk = min(d_max, 32)``;
* LT: each frontier vertex draws ``r``, the uniform of key ``sub`` at
  ``b * n + v``, and follows in-edge ``c`` = the number of the row's
  cumulative weights (summed in XLA's blocked order, float32) at or
  below ``r``, if ``c`` is below its in-degree.

Newly reached vertices form the next frontier; at most ``max_steps``
steps.  ``precision="bfloat16"`` rounds the probabilities, cumulative
weights and uniforms to bfloat16 before comparing (the control).
"""
from __future__ import annotations

import torch

from portbench.reference.threefry import M32, Key, block, to_float

COIN_CHUNK = 32
# coins evaluated at once: bounds the temporaries of one expansion
BLOCK = 1 << 24


def xla_cumsum(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """float32 running sums along the last axis in XLA's CPU order:
    sequential within blocks of ``base``, plus the (recursively blocked)
    sum of the earlier blocks' totals."""
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


class Graph:
    """The reverse CSR (in-edges of each vertex in row order) on a
    device, with what the two models read."""

    def __init__(self, indptr, indices, probs, weights, *, device):
        def put(a, dtype):
            return torch.as_tensor(a).to(device=device, dtype=dtype)
        self.device = torch.device(device)
        self.indptr = put(indptr, torch.int64)
        self.src = put(indices, torch.int64)
        self.prob = put(probs, torch.float32)
        self.n = int(self.indptr.shape[0]) - 1
        self.deg = self.indptr[1:] - self.indptr[:-1]
        self.d = int(self.deg.max()) if self.n else 0
        self.chunk = max(1, min(self.d, COIN_CHUNK))
        self.weights = put(weights, torch.float32)
        self._cumw = None
        self._rising = None

    def slots(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(row, slot) of every edge in row order."""
        row = torch.repeat_interleave(
            torch.arange(self.n, device=self.device), self.deg)
        return row, torch.arange(row.numel(), device=self.device) \
            - self.indptr[row]

    def cumw(self) -> torch.Tensor:
        """float32 [n, d]: running sums of each row's weights, its
        padded slots adding 0."""
        if self._cumw is None:
            row, slot = self.slots()
            wt = torch.zeros((self.n, max(self.d, 1)), dtype=torch.float32,
                             device=self.device)
            wt[row, slot] = self.weights
            self._cumw = xla_cumsum(wt)
        return self._cumw

    def rising(self) -> torch.Tensor:
        """bool [n]: rows whose running sums never fall from one slot to
        the next (the padded slots included), so that a binary search
        finds how many lie at or below a draw."""
        if self._rising is None:
            cw = self.cumw()
            self._rising = (cw[:, 1:] >= cw[:, :-1]).all(1)
        return self._rising


def roots(g: Graph, kc: Key, cols: torch.Tensor) -> torch.Tensor:
    """The roots of samples ``cols`` of a draw under ``kc``."""
    return kc.split()[0].randint_at(cols, g.n)


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return x
    if precision == "bfloat16":
        return x.to(torch.bfloat16)
    raise ValueError(f"unknown precision {precision!r}")


def _ic_hits(g: Graph, sub: Key, b, v, precision: str):
    """(frontier entry, source) of each fired in-edge of the frontier
    (sample b, vertex v)."""
    n_keys = -(-max(g.d, 1) // g.chunk)
    keys = [sub.fold_in(c) for c in range(n_keys)]
    k0 = torch.tensor([k.k0 for k in keys], dtype=torch.int64,
                      device=g.device)
    k1 = torch.tensor([k.k1 for k in keys], dtype=torch.int64,
                      device=g.device)
    deg = g.deg[v]
    out_b, out_u = [], []
    # frontier pieces whose in-edges number at most BLOCK
    ends = torch.cumsum(deg, 0)
    lo = 0
    while lo < v.numel():
        base = int(ends[lo - 1]) if lo else 0
        hi = int(torch.searchsorted(ends, base + BLOCK, right=True))
        hi = max(hi, lo + 1)
        bb, vv, dd = b[lo:hi], v[lo:hi], deg[lo:hi]
        pair = torch.repeat_interleave(
            torch.arange(bb.numel(), device=g.device), dd)
        first = torch.cumsum(dd, 0) - dd
        j = torch.arange(pair.numel(), device=g.device) - first[pair]
        vj, bj = vv[pair], bb[pair]
        edge = g.indptr[vj] + j
        idx = (bj * g.n + vj) * g.chunk + j % g.chunk
        # the in-edge's coin: key fold_in(j // chunk), element idx
        c = j // g.chunk
        y0, y1 = block(k0[c], k1[c], idx >> 32, idx & M32)
        u = to_float(y0 ^ y1)
        fire = _round(u, precision) < _round(g.prob[edge], precision)
        out_b.append(lo + pair[fire])
        out_u.append(g.src[edge][fire])
        lo = hi
    return torch.cat(out_b), torch.cat(out_u)


def _lt_hits(g: Graph, sub: Key, b, v, precision: str):
    """(frontier entry, source) of the in-edge each frontier entry
    (sample b, vertex v) follows: ``chosen`` = the number of the row's
    ``d`` cumulative weights at or below the draw ``r`` (a binary search
    where the row never falls, a count elsewhere)."""
    r = _round(sub.uniform_at(b * g.n + v), precision)
    cw = _round(g.cumw(), precision)
    rising = g.rising()[v]
    chosen = torch.empty(v.shape, dtype=torch.int64, device=g.device)
    # rows that never fall: the first slot whose sum is above r
    at = torch.nonzero(rising)[:, 0]
    lo = torch.zeros(at.shape, dtype=torch.int64, device=g.device)
    hi = torch.full(at.shape, g.d, dtype=torch.int64, device=g.device)
    flat, rv, rr = cw.reshape(-1), v[at] * g.d, r[at]
    while bool((lo < hi).any()):
        mid = (lo + hi) // 2
        below = flat[rv + mid.clamp(max=g.d - 1)] <= rr
        step = lo < hi
        lo = torch.where(step & below, mid + 1, lo)
        hi = torch.where(step & ~below, mid, hi)
    chosen[at] = lo
    # the others, a block of rows at a time
    at = torch.nonzero(~rising)[:, 0]
    rows = max(1, BLOCK // max(g.d, 1))
    for i in range(0, at.numel(), rows):
        part = at[i:i + rows]
        chosen[part] = (cw[v[part]] <= r[part, None]).sum(1)
    ok = chosen < g.deg[v]
    edge = g.indptr[v[ok]] + chosen[ok]
    return torch.nonzero(ok)[:, 0], g.src[edge]


def rrr_sets(g: Graph, kc: Key, cols: torch.Tensor, *, model: str,
             max_steps: int, precision: str = "float32"):
    """The RRR sets of samples ``cols`` (int64, distinct) of a draw under
    ``kc``, as pairs (position in ``cols``, vertex), int64 each."""
    cols = cols.to(device=g.device, dtype=torch.int64)
    hits = {"IC": _ic_hits, "LT": _lt_hits}[model]
    c = cols.numel()
    pos = torch.arange(c, device=g.device)
    front_v = roots(g, kc, cols)
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
