"""Streaming-receiver insertion of a candidate chunk into all threshold
buckets (``csrc/bucket_insert.cu``) and its plain PyTorch version (the
scan receiver).

Replaces ``repro/kernels/bucket_insert.py``: ``bucket_insert_chunk_pallas``
(TPU kernel #4).  Candidates insert in arrival order; a candidate
enters bucket b when its id is valid, the bucket holds fewer than k
seeds and ``float32(gain) >= thresholds[b]``.  One block per bucket,
cover in shared memory; bound on the H100: bytes.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitset
from repro_torch.kernels import ops

_ARGS = [ops.PTR] * 9 + [ops.I64] * 4


def bucket_insert_plain(seed_ids, rows, covers, counts, seeds, thresholds):
    covers, counts, seeds = covers.clone(), counts.clone(), seeds.clone()
    b, k = seeds.shape
    ar = torch.arange(b, device=covers.device)
    for c in range(seed_ids.shape[0]):
        row = rows[c]
        gains = bitset.marginal_gain(row[None, :], covers)
        accept = ((seed_ids[c] >= 0) & (counts < k)
                  & (gains.to(torch.float32) >= thresholds))
        covers = torch.where(accept[:, None], covers | row, covers)
        slot = counts.clamp(0, k - 1).long()
        seeds[ar, slot] = torch.where(accept, seed_ids[c], seeds[ar, slot])
        counts = counts + accept.to(torch.int32)
    return covers, counts, seeds


def bucket_insert_chunk(seed_ids, rows, covers, counts, seeds, thresholds):
    """seed_ids int32 [C] (-1 skipped), rows int32 [C, W], covers int32
    [B, W], counts int32 [B], seeds int32 [B, k], thresholds float32 [B]
    -> (covers, counts, seeds) after the whole chunk."""
    if not ops.on_card(seed_ids, rows, covers, counts, seeds, thresholds):
        return bucket_insert_plain(seed_ids, rows, covers, counts, seeds,
                                   thresholds)
    c = seed_ids.shape[0]
    b, w = covers.shape
    k = seeds.shape[1]
    ops.check(seed_ids, "seed_ids", torch.int32, (c,))
    ops.check(rows, "rows", torch.int32, (c, w))
    ops.check(covers, "covers", torch.int32, (b, w))
    ops.check(counts, "counts", torch.int32, (b,))
    ops.check(seeds, "seeds", torch.int32, (b, k))
    ops.check(thresholds, "thresholds", torch.float32, (b,))
    covers_out = torch.empty_like(covers)
    counts_out = torch.empty_like(counts)
    seeds_out = torch.empty_like(seeds)
    if b == 0:
        return covers_out, counts_out, seeds_out
    ops.launch("bucket_insert", "bucket_insert", "bucket_insert", _ARGS,
               seed_ids.data_ptr(), rows.data_ptr(), thresholds.data_ptr(),
               covers.data_ptr(), counts.data_ptr(), seeds.data_ptr(),
               covers_out.data_ptr(), counts_out.data_ptr(), seeds_out.data_ptr(),
               b, c, w, k)
    return covers_out, counts_out, seeds_out
