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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

_RESIDENT_ARGS = [ops.PTR] * 7 + [ops.I64] * 4
_STREAMED_ARGS = [ops.PTR] * 6 + [ops.I64] * 3


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
