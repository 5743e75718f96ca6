"""Streaming-receiver insertion of candidates into all threshold buckets
(``csrc/bucket_insert.cu``) and the plain PyTorch versions (the scan
receiver).

Replaces ``repro/kernels/bucket_insert.py``: ``bucket_insert_chunk_pallas``
(TPU kernel #4, one chunk) and ``bucket_insert_stream_pallas`` (TPU
kernel #5, a whole [R, C] stream in one launch, the next rows staged
into shared memory while the current ones insert).  Candidates insert in
arrival order; a candidate enters bucket b when its id is valid, the
bucket holds fewer than k seeds and ``float32(gain) >= thresholds[b]``.
One block per bucket, cover in shared memory; bound on the H100: bytes.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitset
from repro_torch.kernels import build, ops

_ARGS = [ops.PTR] * 9 + [ops.I64] * 4
_STREAM_ARGS = [ops.PTR] * 9 + [ops.I64] * 5


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


def bucket_insert_stream_plain(seed_ids, rows, covers, counts, seeds,
                               thresholds):
    """:func:`bucket_insert_plain` folded over the R chunks."""
    for r in range(seed_ids.shape[0]):
        covers, counts, seeds = bucket_insert_plain(
            seed_ids[r], rows[r], covers, counts, seeds, thresholds)
    return covers, counts, seeds


def bucket_insert_stream(seed_ids, rows, covers, counts, seeds, thresholds):
    """seed_ids int32 [R, C] (-1 skipped), rows int32 [R, C, W], the
    bucket state as :func:`bucket_insert_chunk` -> (covers, counts,
    seeds) after the whole stream, in one launch.  Any C runs: the
    kernel stages at most :func:`stream_chunk_capacity` candidates at a
    time.  An empty stream returns the state unchanged."""
    if seed_ids.numel() == 0:
        return covers, counts, seeds
    if not ops.on_card(seed_ids, rows, covers, counts, seeds, thresholds):
        return bucket_insert_stream_plain(seed_ids, rows, covers, counts,
                                          seeds, thresholds)
    r, c = seed_ids.shape
    b, w = covers.shape
    k = seeds.shape[1]
    ops.check(seed_ids, "seed_ids", torch.int32, (r, c))
    ops.check(rows, "rows", torch.int32, (r, c, w))
    ops.check(covers, "covers", torch.int32, (b, w))
    ops.check(counts, "counts", torch.int32, (b,))
    ops.check(seeds, "seeds", torch.int32, (b, k))
    ops.check(thresholds, "thresholds", torch.float32, (b,))
    covers_out = torch.empty_like(covers)
    counts_out = torch.empty_like(counts)
    seeds_out = torch.empty_like(seeds)
    if b == 0:
        return covers_out, counts_out, seeds_out
    ops.launch("bucket_insert_stream", "bucket_insert", "bucket_insert_stream",
               _STREAM_ARGS, seed_ids.data_ptr(), rows.data_ptr(),
               thresholds.data_ptr(), covers.data_ptr(), counts.data_ptr(),
               seeds.data_ptr(), covers_out.data_ptr(), counts_out.data_ptr(),
               seeds_out.data_ptr(), b, r, c, w, k)
    return covers_out, counts_out, seeds_out


def stream_chunk_capacity(num_words: int, device) -> int:
    """The largest count of candidates whose double buffer ([2, C, W]
    words) fits the stream kernel's shared memory next to one cover (0
    when none does), asked of the CUDA ``device``."""
    with torch.cuda.device(device):
        return int(build.function("bucket_insert", "stream_chunk_capacity",
                                  [ops.I64])(num_words))


def auto_chunk_size(num_words: int, total: int, device) -> int:
    """The pipelined receiver's chunk size (stands in for the reference's
    VMEM-budget solve, ``vmem_budget.receiver_chunk_size``): on a CUDA
    device the stream kernel's capacity, at least 1; on the CPU the
    whole stream.  At most the stream; results never depend on it."""
    if torch.device(device).type == "cuda":
        c = max(1, stream_chunk_capacity(num_words, device))
    else:
        c = max(1, total)
    return min(c, total) if total > 0 else c
