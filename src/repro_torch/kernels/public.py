"""The reference's public kernel entry points (``repro/kernels/ops.py``),
reached as ``repro_torch.kernels.ops.<name>``.

Each takes the reference's shapes and returns its tuple: the solvers
and sweeps take one machine's rows [n, W] and hand [1, n, W] to the
port's machine-axis wrappers.  Words are int32 bit patterns.  CPU
tensors take the plain versions, CUDA tensors launch the kernels, as
every wrapper of the port does.  ``block_v`` is accepted and ignored:
the CUDA kernels size their own blocks.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (bucket, bucket_insert, coverage,
                                 greedy_pick, lazy_greedy, rrr_expand,
                                 topk_gain)


def marginal_gain(rows: torch.Tensor, covered: torch.Tensor) -> torch.Tensor:
    """rows int32 [n, W], covered int32 [W] -> int32 [n] gains."""
    return coverage.marginal_gain(rows[None], covered[None])[0]


def bucket_gains(row: torch.Tensor, covers: torch.Tensor) -> torch.Tensor:
    """row int32 [W], covers int32 [B, W] -> int32 [B] gains."""
    return bucket.bucket_gains(row, covers)


def best_gain_index(rows: torch.Tensor, covered: torch.Tensor,
                    picked: torch.Tensor):
    """rows [n, W], covered [W], picked bool [n] -> (best gain [], its
    lowest index []), picked rows masked out."""
    best, index = topk_gain.best_gain_index(rows[None], covered[None],
                                            picked[None])
    return best[0], index[0]


def greedy_maxcover_resident(rows: torch.Tensor, k: int,
                             excluded: torch.Tensor | None = None):
    """rows [n, W] -> (seeds [k], sel_rows [k, W], covered [W], gains
    [k]); ``excluded`` int32 [E] (-1 pads) never picked."""
    out = greedy_pick.greedy_maxcover_resident(rows[None].contiguous(), k,
                                               excluded)
    return tuple(o[0] for o in out)


def greedy_maxcover_lazy(rows: torch.Tensor, k: int,
                         excluded: torch.Tensor | None = None):
    """As :func:`greedy_maxcover_resident`, plus ``tiles_swept`` []."""
    out = lazy_greedy.greedy_maxcover_lazy(rows[None].contiguous(), k,
                                           excluded)
    return tuple(o[0] for o in out)


def greedy_maxcover_resident_batch(rows: torch.Tensor, k: int,
                                   excluded: torch.Tensor):
    """B queries (``excluded`` int32 [B, E]) over one pool [n, W]: the
    resident tuple with a leading [B] axis."""
    return greedy_pick.greedy_maxcover_resident_batch(rows, k, excluded)


def greedy_maxcover_lazy_batch(rows: torch.Tensor, k: int,
                               excluded: torch.Tensor):
    """As :func:`greedy_maxcover_resident_batch`, plus ``tiles_swept``."""
    return lazy_greedy.greedy_maxcover_lazy_batch(rows, k, excluded)


def rrr_expand_step(frontier, visited, fwd_nbr, gmask,
                    block_v: int | None = None):
    """Streamed layout: gmask int32 [n, df, W], zero at padded slots ->
    (new_frontier, new_visited)."""
    return rrr_expand.rrr_expand_step(frontier, visited, fwd_nbr, gmask)


def rrr_expand_step_resident(frontier, visited, fwd_nbr, gidx, plane,
                             block_v: int | None = None):
    """Resident layout: gidx in [0, rows], ``rows`` reading a zero row
    -> (new_frontier, new_visited)."""
    return rrr_expand.rrr_expand_step_resident(frontier, visited, fwd_nbr,
                                               gidx, plane)


def bucket_insert_chunk(seed_ids, rows, covers, counts, seeds, thresholds):
    """One chunk (ids [C], rows [C, W]) through every bucket ->
    (covers, counts, seeds)."""
    return bucket_insert.bucket_insert_chunk(seed_ids, rows, covers, counts,
                                             seeds, thresholds)


def bucket_insert_stream(seed_ids, rows, covers, counts, seeds, thresholds):
    """A chunked stream (ids [R, C], rows [R, C, W]) through every
    bucket -> (covers, counts, seeds)."""
    return bucket_insert.bucket_insert_stream(seed_ids, rows, covers,
                                              counts, seeds, thresholds)
