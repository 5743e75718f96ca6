"""One greedy pick — the masked gain sweep fused with the argmax
(``csrc/topk_gain.cu``) — and the plain PyTorch version.

Replaces ``repro/kernels/topk_gain.py``: ``best_gain_index_pallas`` (TPU
kernel #7), the per-pick engine of ``solver="fused"``, with a leading
machine axis (``topk_gain``), and its vmap over queries in
``repro/core/maxcover.py:141`` (``topk_gain_batch``: B queries over one
shared row pool, read once a pick for each group of queries whose
covers fit in a block's shared memory, :func:`greedy_pick.query_groups`).
Picked rows score -1; ties go to the lowest row index, as ``jnp.argmax``
breaks them.  Bound on the H100: bytes (the rows, read once per pick).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import coverage, ops

# The contract checker's declaration (``repro_torch/analysis/contracts.py``):
# one launch a pick, on either axis.
CONTRACT = dict(
    family="topk_gain",
    dtypes=("bool", "int32", "int64"),
    variants=dict(
        fused=dict(launches={"topk_gain": 1}, per_step=True),
        # best_gain_batch_kernel<7> keeps an 8-byte stack frame
        batch=dict(launches={"topk_gain_batch": 1}, per_step=True,
                   local_memory=("topk_gain_batch",)),
    ),
)

_ARGS = [ops.PTR] * 6 + [ops.I64] * 3
_BATCH_ARGS = [ops.PTR] * 6 + [ops.I64] * 4


def best_gain_index_plain(rows, covered, picked):
    """rows int32 [m, n, W] (or an expanded view of one shared pool),
    covered int32 [m, W], picked bool [m, n] -> (best gain, best index),
    int32 [m] each."""
    return best_of(coverage.marginal_gain_plain(rows, covered), picked)


def best_of(gains, picked):
    """gains int32 [m, n], picked bool [m, n] -> (best masked gain, its
    lowest index), int32 [m] each: picked rows score -1."""
    g = torch.where(picked, -1, gains)
    best = torch.argmax(g, dim=1)
    return g.gather(1, best[:, None])[:, 0], best.to(torch.int32)


def _launch(counter: str, fn: str, argtypes, rows, covered, picked, m: int,
            *sizes: int):
    dev = rows.device
    keys = torch.zeros((m,), dtype=torch.int64, device=dev)
    best = torch.empty((m,), dtype=torch.int32, device=dev)
    index = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return best, index
    ops.launch(counter, "topk_gain", fn, argtypes, rows.data_ptr(),
               covered.data_ptr(), picked.data_ptr(), keys.data_ptr(),
               best.data_ptr(), index.data_ptr(), m, *sizes)
    return best, index


def best_gain_index(rows: torch.Tensor, covered: torch.Tensor,
                    picked: torch.Tensor):
    """The best masked gain of each machine and its lowest row index."""
    m, n, w = rows.shape
    if n == 0:
        raise ValueError("best_gain_index needs at least one row")
    if not ops.on_card(rows, covered, picked):
        return best_gain_index_plain(rows, covered, picked)
    ops.check(rows, "rows", torch.int32, (m, n, w))
    ops.check(covered, "covered", torch.int32, (m, w))
    ops.check(picked, "picked", torch.bool, (m, n))
    return _launch("topk_gain", "best_gain_index", _ARGS, rows, covered,
                   picked, m, n, w)


def best_gain_index_batch(rows: torch.Tensor, covered: torch.Tensor,
                          picked: torch.Tensor):
    """One pick of each of B queries over one shared pool ``rows`` int32
    [n, W]: covered int32 [B, W], picked bool [B, n] -> (best gain,
    best index), int32 [B] each.  The pool is read in place, once for
    each group of queries; a W whose cover alone does not fit in a
    block's shared memory raises."""
    # greedy_pick imports this module for its plain pick
    from repro_torch.kernels import greedy_pick

    n, w = rows.shape
    b = covered.shape[0]
    if n == 0:
        raise ValueError("best_gain_index needs at least one row")
    if not ops.on_card(rows, covered, picked):
        return best_gain_index_plain(rows[None].expand(b, n, w), covered,
                                     picked)
    ops.check(rows, "rows", torch.int32, (n, w))
    ops.check(covered, "covered", torch.int32, (b, w))
    ops.check(picked, "picked", torch.bool, (b, n))
    g = greedy_pick.query_plan("topk_gain", b, w, rows.device)[0] if b else 1
    return _launch("topk_gain_batch", "best_gain_index_batch", _BATCH_ARGS,
                   rows, covered, picked, b, n, w, g)
