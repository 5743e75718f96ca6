"""Fused packed BFS expansion step (``csrc/rrr_expand.cu``), both
gather layouts, with their plain PyTorch versions.

Replaces ``repro/kernels/rrr_expand.py``: ``rrr_expand_step_resident_pallas``
(TPU kernel #1) and ``rrr_expand_step_pallas`` (#2).  One step computes

    hit = OR_s frontier[fwd_nbr[:, s]] & mask[:, s]
    new = hit & ~visited;  visited_out = visited | new

where the mask word is ``plane[gidx[u, s]]`` (resident layout; ``gidx``
equal to ``plane.shape[0]`` reads a zero row — the sentinel of invalid
slots) or ``gmask[u, s]`` (streamed layout, pre-gathered).  ``fwd_nbr``
is pre-clipped to 0 at invalid slots.  Bound on the H100: bytes (the
frontier-row gathers and the mask words); see the CUDA source for the
design.  The kernel is direction-agnostic, so the cascade's forward
diffusion uses it too.

The IC sampler's step is ``rrr_expand_step_ic`` (kernel
``rrr_expand_ic``): the resident layout with the mask word drawn where
it is needed — bit ``b`` of the mask at ``(u, s, w)`` is the IC coin of
sample ``32 w + b`` on the edge of slot ``s`` (``kernels.coins``), hashed
only behind a set frontier bit — so the coin plane of ``coin_pack`` is
never built.  The result equals ``rrr_expand_step_resident`` over
``coins.coin_plane`` word for word.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitset
from repro_torch.core.prng import Key
from repro_torch.kernels import coins, ops

_RESIDENT_ARGS = [ops.PTR] * 7 + [ops.I64] * 4
_STREAMED_ARGS = [ops.PTR] * 6 + [ops.I64] * 3
_IC_ARGS = [ops.PTR] * 8 + [ops.I64] * 5


def _finish(hit, visited):
    new = hit & ~visited
    return new, visited | new


def expand_step_resident_plain(frontier, visited, fwd_nbr, gidx, plane):
    rows = plane.shape[0]
    hit = torch.zeros_like(frontier)
    for s in range(fwd_nbr.shape[1]):
        g = gidx[:, s].long()
        if rows:
            m = plane[g.clamp(max=rows - 1)] & torch.where(
                g < rows, -1, 0).to(plane.dtype)[:, None]
            hit |= frontier[fwd_nbr[:, s].long()] & m
    return _finish(hit, visited)


def expand_step_plain(frontier, visited, fwd_nbr, gmask):
    hit = torch.zeros_like(frontier)
    for s in range(fwd_nbr.shape[1]):
        hit |= frontier[fwd_nbr[:, s].long()] & gmask[:, s]
    return _finish(hit, visited)


def rrr_expand_step_resident(frontier, visited, fwd_nbr, gidx, plane):
    """Resident layout: frontier/visited int32 [n, W], fwd_nbr/gidx int32
    [n, df] (gidx in [0, rows]), plane int32 [rows, W]
    -> (new_frontier, new_visited)."""
    if not ops.on_card(frontier, visited, fwd_nbr, gidx, plane):
        return expand_step_resident_plain(frontier, visited, fwd_nbr, gidx,
                                          plane)
    n, w = frontier.shape
    df = fwd_nbr.shape[1]
    ops.check(frontier, "frontier", torch.int32, (n, w))
    ops.check(visited, "visited", torch.int32, (n, w))
    ops.check(fwd_nbr, "fwd_nbr", torch.int32, (n, df))
    ops.check(gidx, "gidx", torch.int32, (n, df))
    ops.check(plane, "plane", torch.int32, (None, w))
    newf, viso = torch.empty_like(frontier), torch.empty_like(visited)
    if n * w == 0:
        return newf, viso
    ops.launch("rrr_expand_resident", "rrr_expand", "rrr_expand_resident",
               _RESIDENT_ARGS, frontier.data_ptr(), visited.data_ptr(),
               fwd_nbr.data_ptr(), gidx.data_ptr(), plane.data_ptr(),
               newf.data_ptr(), viso.data_ptr(), n, df, w, plane.shape[0])
    return newf, viso


def rrr_expand_step(frontier, visited, fwd_nbr, gmask):
    """Streamed layout: gmask int32 [n, df, W], zero at invalid slots."""
    if not ops.on_card(frontier, visited, fwd_nbr, gmask):
        return expand_step_plain(frontier, visited, fwd_nbr, gmask)
    n, w = frontier.shape
    df = fwd_nbr.shape[1]
    ops.check(frontier, "frontier", torch.int32, (n, w))
    ops.check(visited, "visited", torch.int32, (n, w))
    ops.check(fwd_nbr, "fwd_nbr", torch.int32, (n, df))
    ops.check(gmask, "gmask", torch.int32, (n, df, w))
    newf, viso = torch.empty_like(frontier), torch.empty_like(visited)
    if n * w == 0:
        return newf, viso
    ops.launch("rrr_expand_streamed", "rrr_expand", "rrr_expand_streamed",
               _STREAMED_ARGS, frontier.data_ptr(), visited.data_ptr(),
               fwd_nbr.data_ptr(), gmask.data_ptr(), newf.data_ptr(),
               viso.data_ptr(), n, df, w)
    return newf, viso


def expand_step_ic_plain(frontier, visited, nbr_c, gidx, prob_p,
                         keys: list[Key], chunk: int):
    """Builds no plane: per forward slot, the live (u, w) — a valid slot
    (``gidx`` below the sentinel ``n * d_pad``) with ``p > 0`` whose
    frontier word is non-zero — and their set bits, hashed through
    ``Key.uniform_at`` at the reference's flat draw indices."""
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


def rrr_expand_step_ic(frontier, visited, nbr_c, gidx, prob_p,
                       keys: list[Key], chunk: int):
    """IC step with the coins drawn in the expansion: frontier/visited
    int32 [n, W], nbr_c/gidx int32 [n, df] (``gidx`` = v * d_pad +
    reverse slot, ``n * d_pad`` at invalid slots), prob_p float32 [n,
    d_pad], one key per chunk of ``chunk`` reverse slots ->
    (new_frontier, new_visited)."""
    n, w = frontier.shape
    df = nbr_c.shape[1]
    d_pad = prob_p.shape[1]
    if len(keys) * chunk != d_pad:
        raise ValueError(f"{len(keys)} chunk keys x {chunk} slots != "
                         f"d_pad {d_pad}")
    ops.check(frontier, "frontier", torch.int32, (n, w))
    ops.check(visited, "visited", torch.int32, (n, w))
    ops.check(nbr_c, "nbr_c", torch.int32, (n, df))
    ops.check(gidx, "gidx", torch.int32, (n, df))
    ops.check(prob_p, "prob_p", torch.float32, (n, d_pad))
    if not ops.on_card(frontier, visited, nbr_c, gidx, prob_p):
        return expand_step_ic_plain(frontier, visited, nbr_c, gidx, prob_p,
                                    keys, chunk)
    key_words = coins.key_words(keys, frontier.device)
    newf, viso = torch.empty_like(frontier), torch.empty_like(visited)
    if n * w == 0:
        return newf, viso
    ops.launch("rrr_expand_ic", "rrr_expand", "rrr_expand_ic", _IC_ARGS,
               frontier.data_ptr(), visited.data_ptr(), nbr_c.data_ptr(),
               gidx.data_ptr(), prob_p.data_ptr(), key_words.data_ptr(),
               newf.data_ptr(), viso.data_ptr(), n, df, d_pad, chunk, w)
    return newf, viso
