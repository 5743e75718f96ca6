"""Bit-packed Monte-Carlo cascade simulation (twin of
``repro.core.cascade``): the expected spread of a seed set.

Frontier/active state is word-packed int32 ``[n, num_sims/32]`` and one
diffusion step is a gather over the padded *reverse* adjacency,
``hit[v] |= frontier[nbr[v, slot]] & live[v, slot]`` — the mirror of
the RRR sampler's reverse BFS.  Live edges are the reference's, drawn
once per simulation and keyed per lane (``fold_in(fold_in(key, chunk),
sim)``).

- ``engine="kernel"``, ``gather="auto"``: each step is one kernel that
  draws the live edges itself, so no live-edge plane is built:
  ``cascade_ic`` (``kernels.rrr_expand.cascade_step_ic``) hashes the
  coin of an in-edge only behind a frontier bit that can still become
  new; ``cascade_lt`` (``cascade_step_lt``) draws a simulation's one
  live in-edge of a vertex only for an open bit that some in-neighbour's
  frontier word holds.  The loop stops on the kernel's count of new
  words.
- ``gather="resident"`` or ``"streamed"``: the live plane ``[n, d_pad,
  W]`` is drawn in plain PyTorch (``_live_mask``) and read by the
  sampler's expansion kernel, in gather order (``streamed``,
  ``rrr_expand_streamed``) or through the identity index ``v * d_pad +
  slot`` (``resident``, ``rrr_expand_resident``), each row's valid
  slots alone (their count per row, built once) and only the frontier
  lines its line summary marks live (from the seed rows, then written
  by each step); the loop stops on the kernel's count of non-zero lines.
- ``engine="packed"``: the plane and the plain PyTorch step, with the
  same inputs and stop.
- ``engine="map"``: the per-simulation oracle in plain PyTorch, one
  bool ``[n]`` state per simulation.  IC/WC fire the out-edges of each
  active vertex over the forward table, each forward slot's coin
  gathered through ``(fwd_nbr, fwd_rslot)`` from that simulation's own
  reverse-slot draw; LT follows each vertex's one chosen in-edge.

All are bit-identical to the reference's engines.  Models: IC, WC (IC
dynamics with the normalized LT weight as the probability, so a weight
of 1.0 fires surely) and LT (live-edge form).
"""
from __future__ import annotations

import contextlib
from typing import Literal

import torch

from repro_torch.core import bitset
from repro_torch.core.prng import Key
from repro_torch.core.rrr import GATHERS, _coin_chunks, xla_cumsum
from repro_torch.graphs.csr import (CSRGraph, padded_adjacency,
                                    padded_forward_adjacency)
from repro_torch.kernels import rrr_expand

Model = Literal["IC", "LT", "WC"]

# The contract checker's declaration (``repro_torch/analysis/contracts.py``):
# the kernel engine's launches a diffusion step, by model and gather.
CONTRACT = dict(
    family="cascade",
    dtypes=("bool", "float32", "int32", "int64", "uint8"),
    variants=dict(
        kernel=dict(launches={"cascade_ic": 1}, per_step=True),
        lt=dict(launches={"cascade_lt": 1}, per_step=True),
        resident=dict(launches={"rrr_expand_resident": 1}, per_step=True),
    ),
)

MODELS = ("IC", "LT", "WC")
ENGINES = ("map", "packed", "kernel")


def resolve_engine(engine: str | None, default: str = "kernel") -> str:
    if engine is None:
        engine = default
    if engine not in ENGINES:
        raise ValueError(
            f"unknown cascade engine {engine!r}; expected one of {ENGINES}")
    return engine


def resolve_model(model: str | None, default: str = "IC") -> str:
    if model is None:
        model = default
    if model not in MODELS:
        raise ValueError(
            f"unknown diffusion model {model!r}; expected one of {MODELS}")
    return model


def seeds_to_mask(n: int, seeds, *, device) -> torch.Tensor:
    """bool [n] seed mask with -1 pads and out-of-range ids dropped."""
    seeds = torch.as_tensor(seeds).reshape(-1).long().to(device)
    ok = (seeds >= 0) & (seeds < n)
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    mask[seeds[ok]] = True
    return mask


def _edge_prob(nbr, prob, wt, model: str):
    """The firing probability of each reverse slot: ``prob`` under IC,
    the normalized LT weight under WC (zero at pads)."""
    return prob if model == "IC" else torch.where(nbr >= 0, wt, 0.0)


def _live_mask(nbr, prob, wt, key: Key, *, model, num_sims, chunk,
               n_chunks, d_pad):
    """int32 [n, d_pad, W]: bit s of word s//32 at [v, slot] is set iff
    in-edge ``slot`` of v is live in simulation s.  IC and WC fire with
    ``prob`` (WC's callers pass :func:`_edge_prob`)."""
    n, d = nbr.shape
    dev = nbr.device
    w = bitset.num_words(num_sims)
    live = torch.zeros((n, d_pad, w), dtype=torch.int32, device=dev)
    if model != "LT":
        prob_p = torch.nn.functional.pad(prob, (0, d_pad - d))
        for c in range(n_chunks):
            kc = key.fold_in(c)
            p_c = prob_p[:, c * chunk:(c + 1) * chunk]
            for s in range(num_sims):
                fire = kc.fold_in(s).uniform((n, chunk), device=dev) < p_c
                live[:, c * chunk:(c + 1) * chunk, s // 32] |= \
                    bitset.to_words(fire.to(torch.int64) << (s % 32))
    else:   # LT live edge: one selected in-edge per (simulation, vertex)
        cumw = xla_cumsum(wt)
        in_deg = (nbr >= 0).sum(1)
        v = torch.arange(n, device=dev)
        for s in range(num_sims):
            r = key.fold_in(s).uniform((n,), device=dev)
            chosen = (cumw <= r[:, None]).sum(1)
            ok = chosen < in_deg
            live[v[ok], chosen[ok], s // 32] |= \
                bitset.to_words(torch.tensor(1 << (s % 32), device=dev))
    return live


# Measurement hook (``tools/time_spread.py``): when set, called with the
# name of each part of a run (``padded_adjacency``; ``keys`` on the
# kernel routes, with ``tbl`` for LT's cumulative weights, else ``tbl``
# and ``live``; ``step`` and ``sync`` for each step; the spread's final
# ``popcount``), returning the context that spans it.
_clock = None


def _span(name: str):
    return contextlib.nullcontext() if _clock is None else _clock(name)


def simulate_cascades(g: CSRGraph, seeds, key: Key, *, model: str = "IC",
                      num_sims: int = 64, max_steps: int = 64,
                      engine: str = "kernel", coin_chunk: int = 32,
                      gather: str = "auto") -> torch.Tensor:
    """Simulate ``num_sims`` cascades from ``seeds`` (-1 pads dropped);
    return the packed activation incidence int32 [n, ceil(sims/32)]."""
    engine = resolve_engine(engine)
    model = resolve_model(model)
    if gather not in GATHERS:
        raise ValueError(f"unknown gather {gather!r}; expected {GATHERS}")
    n = g.num_vertices
    dev = g.device
    with _span("padded_adjacency"):
        nbr, prob, wt = padded_adjacency(g)
    smask = seeds_to_mask(n, seeds, device=dev)
    lane = bitset.lane_words(num_sims, dev)
    active = torch.where(smask[:, None], lane[None, :], 0).to(torch.int32)
    d = nbr.shape[1]
    if d == 0:          # edgeless graph: nothing ever fires
        return active
    chunk, n_chunks, d_pad = _coin_chunks(d, coin_chunk)
    if model != "LT":
        prob = _edge_prob(nbr, prob, wt, model)
    if engine == "map":
        return _simulate_map(g, nbr, prob, wt, smask, key, model=model,
                             num_sims=num_sims, max_steps=max_steps,
                             chunk=chunk, n_chunks=n_chunks)
    if engine == "kernel" and gather == "auto":
        if model != "LT":
            return _simulate_ic(nbr, prob, key, active, num_sims=num_sims,
                                max_steps=max_steps, chunk=chunk,
                                n_chunks=n_chunks)
        return _simulate_lt(nbr, wt, key, active, num_sims=num_sims,
                            max_steps=max_steps)
    with _span("tbl"):
        tbl = torch.nn.functional.pad(torch.where(nbr >= 0, nbr, 0),
                                      (0, d_pad - d)).contiguous()
    with _span("live"):
        live = _live_mask(nbr, prob, wt, key, model=model, num_sims=num_sims,
                          chunk=chunk, n_chunks=n_chunks, d_pad=d_pad)
    if engine == "kernel" and gather == "resident":
        gidx = (torch.arange(n, dtype=torch.int32, device=dev)[:, None]
                * d_pad + torch.arange(d_pad, dtype=torch.int32,
                                       device=dev)[None, :]).contiguous()
        plane = live.reshape(n * d_pad, -1)

        def expand(frontier, act, **carry):
            return rrr_expand.rrr_expand_step_resident(frontier, act, tbl,
                                                       gidx, plane, **carry)
    elif engine == "kernel":
        def expand(frontier, act, **carry):
            return rrr_expand.rrr_expand_step(frontier, act, tbl, live,
                                              **carry)
    else:
        def expand(frontier, act, **carry):
            return rrr_expand.expand_step_plain(frontier, act, tbl, live,
                                                **carry)
    # valid slots first in each row of the reverse table; the first line
    # summary marks every line of the seed rows
    slots = (nbr >= 0).sum(1, dtype=torch.int32)
    lines = [smask.to(torch.uint8)[:, None].repeat(
        1, rrr_expand.num_lines(lane.numel()))]
    lines.append(torch.empty_like(lines[0]))

    def step(frontier, act, count):
        out = expand(frontier, act, slots=slots, lines=lines[0],
                     next_lines=lines[1], count=count)
        lines.reverse()
        return out
    return _count_loop(step, active, max_steps)


def _simulate_map(g: CSRGraph, nbr, prob, wt, smask, key: Key, *,
                  model: str, num_sims: int, max_steps: int, chunk: int,
                  n_chunks: int):
    """The per-simulation engine: bool ``[n]`` frontier and active state
    for each simulation in turn, packed at the end.  IC/WC scatter over
    the forward table, each forward slot's coin read from the
    simulation's reverse-slot draw ``fold_in(fold_in(key, c), s)
    .uniform((n, chunk))`` through its ``(v, rev_slot)`` pair; LT follows
    the one in-edge chosen by ``sum(r >= cumw)``.  An IC/WC step writes
    True at every launched target, which no order of the writes
    changes."""
    n, d = nbr.shape
    dev = nbr.device
    if model != "LT":
        fwd_nbr, fwd_rslot = padded_forward_adjacency(g)
        fwd_valid = fwd_nbr >= 0
        safe_v = torch.where(fwd_valid, fwd_nbr, 0).long()
        safe_slot = fwd_rslot.clamp(min=0).long()
        tgt = fwd_nbr.long()
        prob_p = torch.nn.functional.pad(prob, (0, n_chunks * chunk - d))
    else:
        cumw = xla_cumsum(wt)
        in_deg = (nbr >= 0).sum(1)
        rows = torch.arange(n, device=dev)
    visited = torch.empty((num_sims, n), dtype=torch.bool, device=dev)
    for s in range(num_sims):
        if model != "LT":
            fr = torch.empty((n, n_chunks * chunk), dtype=torch.bool,
                             device=dev)
            for c in range(n_chunks):
                coins = key.fold_in(c).fold_in(s).uniform((n, chunk),
                                                          device=dev)
                sl = slice(c * chunk, (c + 1) * chunk)
                fr[:, sl] = coins < prob_p[:, sl]
            fire_fwd = fr[safe_v, safe_slot] & fwd_valid
        else:
            r = key.fold_in(s).uniform((n,), device=dev)
            chosen = (r[:, None] >= cumw).sum(1)
            has = chosen < in_deg
            pick = nbr[rows, chosen.clamp(0, d - 1)].clamp(min=0).long()
        frontier = active = smask
        for _ in range(max_steps):
            if not bool(frontier.any()):
                break
            if model != "LT":
                hit = torch.zeros(n, dtype=torch.bool, device=dev)
                hit[tgt[frontier[:, None] & fire_fwd]] = True
            else:
                hit = frontier[pick] & has
            frontier = hit & ~active
            active = active | frontier
        visited[s] = active
    return bitset.pack_bool_matrix(visited.T)


def _simulate_ic(nbr, prob, key: Key, active, *, num_sims: int,
                 max_steps: int, chunk: int, n_chunks: int):
    """The IC kernel route: ``cascade_step_ic`` draws each step's live
    edges itself (no plane), counting the new frontier's non-zero words,
    and the loop stops on that count.  A first step from an empty
    frontier adds nothing, so no check precedes it."""
    with _span("keys"):
        keys = rrr_expand.cascade_keys(key, n_chunks, num_sims, nbr.device)
    return _count_loop(lambda f, act, count: rrr_expand.cascade_step_ic(
        f, act, nbr, prob, keys, chunk, num_sims, count=count), active,
        max_steps)


def _simulate_lt(nbr, wt, key: Key, active, *, num_sims: int,
                 max_steps: int):
    """The LT kernel route: the reference's cumulative weights and their
    row codes built once (``rrr_expand.lt_tables``), the key table
    hashed once, then ``cascade_step_lt`` a step, stopped on its count
    of new words."""
    with _span("tbl"):
        cumw, rows = rrr_expand.lt_tables(nbr, xla_cumsum(wt))
    with _span("keys"):
        keys = rrr_expand.lt_cascade_keys(key, num_sims, nbr.device)
    return _count_loop(lambda f, act, count: rrr_expand.cascade_step_lt(
        f, act, nbr, cumw, rows, keys, num_sims, count=count), active,
        max_steps)


def _count_loop(step, active, max_steps: int):
    """Runs ``step(frontier, active, count)`` until its count (of new
    words, or of the plane routes' non-zero lines) is 0 or ``max_steps``
    steps; returns the active words."""
    count = torch.zeros(1, dtype=torch.int32, device=active.device)
    frontier = active
    for _ in range(max_steps):
        with _span("step"):
            frontier, active = step(frontier, active, count)
        with _span("sync"):
            go = bool(count.item())
        if not go:
            break
    return active


def cascade_counts(g: CSRGraph, seeds, key: Key, *, model: str = "IC",
                   num_sims: int = 64, max_steps: int = 64,
                   engine: str = "kernel", coin_chunk: int = 32,
                   gather: str = "auto") -> torch.Tensor:
    """Per-simulation activation counts int32 [num_sims]."""
    words = simulate_cascades(g, seeds, key, model=model, num_sims=num_sims,
                              max_steps=max_steps, engine=engine,
                              coin_chunk=coin_chunk, gather=gather)
    return bitset.unpack_words(words, num_sims).sum(0, dtype=torch.int32)


def spread(g: CSRGraph, seeds, key: Key, *, model: str = "IC",
           num_sims: int = 64, max_steps: int = 64, engine: str = "kernel",
           coin_chunk: int = 32, gather: str = "auto") -> torch.Tensor:
    """Monte-Carlo estimate of sigma(seeds): float32 mean activation count."""
    words = simulate_cascades(g, seeds, key, model=model, num_sims=num_sims,
                              max_steps=max_steps, engine=engine,
                              coin_chunk=coin_chunk, gather=gather)
    with _span("popcount"):
        total = bitset.coverage_size(words).sum()
        return total.to(torch.float32) / float(num_sims)
