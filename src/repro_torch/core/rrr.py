"""Batched Random-Reverse-Reachable (RRR) set sampling (twin of
``repro.core.rrr``'s packed engine).

Frontier and visited state are word-packed int32 ``[n, batch/32]`` for
the whole BFS, and one expansion is a gather over the padded *forward*
adjacency: ``hit[u] |= frontier[v] & mask[v, rev_slot]`` for every
forward pair ``(v, rev_slot)`` of ``u``.  Two samplers share this
engine and are bit-identical to the reference's ``packed`` and
``kernel`` samplers for the same key and ``coin_chunk``:

  * ``sampler="packed"`` — the plain PyTorch path (coins through
    ``prng``, expansion as tensor gathers);
  * ``sampler="kernel"`` — the coin plane and the expansion run as the
    CUDA kernels ``kernels.coins`` and ``kernels.rrr_expand`` (resident
    layout by default; ``gather="auto"`` means resident here, there is
    no VMEM budget to solve for).

The per-step mask is the reference's coin / selection mask restricted
to the frontier's live words (the expansion ANDs it with the frontier,
so nothing else is ever read).  That keeps the per-step work
proportional to the frontier instead of to batch * n * d.  The BFS
``while_loop`` becomes a host loop that synchronizes once per step on
``frontier.any()``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bitset
from repro_torch.core.prng import Key
from repro_torch.kernels import coins, rrr_expand

SAMPLERS = ("packed", "kernel")
GATHERS = ("resident", "streamed", "auto")


def resolve_sampler(sampler: Optional[str], default: str = "kernel") -> str:
    if sampler is None:
        sampler = default
    if sampler == "dense":
        raise NotImplementedError(
            "sampler='dense' is not ported yet: ROADMAP Queue 1, "
            "'the dense sampler'")
    if sampler not in SAMPLERS:
        raise ValueError(
            f"unknown sampler {sampler!r}; expected one of {SAMPLERS}")
    return sampler


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


def _live_bits(frontier: torch.Tensor):
    """(sample, vertex, word) of every set frontier bit."""
    v, w = torch.nonzero(frontier, as_tuple=True)
    live = bitset.unpack_words(frontier[v, w][:, None], bitset.WORD_BITS)
    p, bit = torch.nonzero(live, as_tuple=True)
    return bitset.WORD_BITS * w[p] + bit, v[p], w[p]


class _Tables:
    """Per-graph tables of one sampling call, built once."""

    def __init__(self, nbr, prob, wt, fwd_nbr, fwd_rslot, *, model: str,
                 coin_chunk: int):
        n, d = nbr.shape
        self.n, self.d = n, d
        self.chunk, self.n_chunks, self.d_pad = _coin_chunks(d, coin_chunk)
        valid = fwd_nbr >= 0
        self.nbr_c = torch.where(valid, fwd_nbr, 0).contiguous()
        self.gidx = torch.where(
            valid, self.nbr_c * self.d_pad + fwd_rslot.clamp(min=0),
            n * self.d_pad).to(torch.int32).contiguous()
        self.rslot = fwd_rslot.clamp(min=0).long()
        self.valid = valid
        if model == "IC":
            self.prob_p = torch.nn.functional.pad(
                prob, (0, self.d_pad - d)).contiguous()
        elif model == "LT":
            self.cumw = xla_cumsum(wt)
            self.in_deg = (nbr >= 0).sum(1)
        else:
            raise ValueError(f"unknown model {model!r}; expected IC or LT")


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


def _expand(t: _Tables, frontier, visited, mask, kernel: bool, gather: str):
    if kernel and gather != "streamed":
        plane = mask.reshape(t.n * t.d_pad, -1)
        return rrr_expand.rrr_expand_step_resident(
            frontier, visited, t.nbr_c, t.gidx, plane)
    gmask = torch.where(t.valid[:, :, None], mask[t.nbr_c.long(), t.rslot], 0)
    if kernel:
        return rrr_expand.rrr_expand_step(frontier, visited, t.nbr_c,
                                          gmask.contiguous())
    return rrr_expand.expand_step_plain(frontier, visited, t.nbr_c, gmask)


def rrr_batch_packed(nbr, prob, wt, fwd_nbr, fwd_rslot, roots, key: Key, *,
                     model: str, max_steps: int = 64, coin_chunk: int = 32,
                     expand: str = "plain", gather: str = "auto",
                     stats: Optional[dict] = None):
    """Packed-state RRR batch -> int32 [n, ceil(batch/32)]: bit i of word
    i//32 at row v is set iff v in RRR(roots[i]).  ``expand`` is "plain"
    (PyTorch coins and gathers) or "kernel" (the CUDA kernels).
    ``stats`` (optional dict) accumulates ``bfs_steps``."""
    if expand not in ("plain", "kernel"):
        raise ValueError(f"expand must be 'plain' or 'kernel', got {expand!r}")
    if gather not in GATHERS:
        raise ValueError(f"unknown gather {gather!r}; expected {GATHERS}")
    kernel = expand == "kernel"
    n, d = nbr.shape
    visited = packed_roots(roots, n)
    if d == 0:          # edgeless graph: RRR(root) = {root}
        return visited
    t = _Tables(nbr, prob, wt, fwd_nbr, fwd_rslot, model=model,
                coin_chunk=coin_chunk)
    frontier = visited
    step = 0
    while step < max_steps and bool(frontier.any()):
        key, sub = key.split()
        mask = (_ic_mask(t, sub, frontier, kernel) if model == "IC"
                else _lt_mask(t, sub, frontier))
        frontier, visited = _expand(t, frontier, visited, mask, kernel,
                                    gather)
        step += 1
    if stats is not None:
        stats["bfs_steps"] = stats.get("bfs_steps", 0) + step
    return visited


def sample_incidence(nbr, prob, wt, key: Key, *, theta: int, n: int,
                     model: str, max_steps: int = 64,
                     sampler: str = "kernel", fwd=None, coin_chunk: int = 32,
                     gather: str = "auto", stats: Optional[dict] = None):
    """Sample ``theta`` RRR sets (theta a multiple of 32); return the
    packed incidence X int32 [n, theta/32] on the tables' device."""
    if theta % bitset.WORD_BITS:
        raise ValueError(f"theta must be a multiple of 32, got {theta}")
    sampler = resolve_sampler(sampler)
    if fwd is None:
        raise ValueError("sample_incidence needs fwd=(fwd_nbr, fwd_rslot) "
                         "from graphs.csr.padded_forward_adjacency")
    kr, kb = key.split()
    roots = kr.randint((theta,), 0, n, device=nbr.device)
    return rrr_batch_packed(
        nbr, prob, wt, fwd[0], fwd[1], roots, kb, model=model,
        max_steps=max_steps, coin_chunk=coin_chunk,
        expand=("kernel" if sampler == "kernel" else "plain"), gather=gather,
        stats=stats)
