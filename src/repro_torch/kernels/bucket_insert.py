"""Streaming-receiver insertion of candidates into all threshold buckets
(``csrc/bucket_insert.cu``) and the plain PyTorch versions (the scan
receiver, and the kernels' grouped settlement).

Replaces ``repro/kernels/bucket_insert.py``: ``bucket_insert_chunk_pallas``
(TPU kernel #4, one chunk) and ``bucket_insert_stream_pallas`` (TPU
kernel #5, a whole [R, C] stream in one launch).  Candidates insert in
arrival order; a candidate enters bucket b when its id is valid, the
bucket holds fewer than k seeds and ``float32(gain) >= thresholds[b]``.
One block per bucket (or a cluster of two splitting its words), cover
in shared memory.  Both launches settle the candidates G at a time
against two bounds of each one's gain (its gain against the cover, and
against the cover ORed with the group's earlier rows), one barrier a
pass, and stop once the bucket is full
(:func:`bucket_insert_grouped_plain` is the same walk in plain PyTorch);
bound on the H100: the rows read per bucket and the passes.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitset
from repro_torch.kernels import build, ops, smem_budget

# The contract checker's declaration (``repro_torch/analysis/contracts.py``):
# one launch a chunk or a whole stream, none for the scan.
CONTRACT = dict(
    family="bucket_insert",
    dtypes=("bool", "float32", "int32", "int64"),
    variants=dict(
        chunk=dict(launches={"bucket_insert": 1}),
        stream=dict(launches={"bucket_insert_stream": 1}),
        scan_ref=dict(launches={}),
    ),
)

_ARGS = [ops.PTR] * 10 + [ops.I64] * 4
_STREAM_ARGS = [ops.PTR] * 10 + [ops.I64] * 5
# The kernels' group size (``RECV_GROUP`` of the CUDA source), and the
# per-bucket figures a launch writes when asked
# (:func:`bucket_insert_with_stats`): the first four are
# :func:`bucket_insert_grouped_plain`'s, then the launch's layout.
GROUP = 32
STATS = ("passes", "ambiguous", "filled_at", "rows_read", "group",
         "cluster")


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
    return _settle(seed_ids, rows, covers, counts, seeds, thresholds)[:3]


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
    kernel reads the stream as one of R * C candidates, a group at a
    time.  An empty stream returns the state unchanged."""
    if seed_ids.numel() == 0:
        return covers, counts, seeds
    if not ops.on_card(seed_ids, rows, covers, counts, seeds, thresholds):
        return bucket_insert_stream_plain(seed_ids, rows, covers, counts,
                                          seeds, thresholds)
    return _settle(seed_ids, rows, covers, counts, seeds, thresholds)[:3]


def bucket_insert_grouped_plain(seed_ids, rows, covers, counts, seeds,
                                thresholds, group: int):
    """The kernels' walk in plain PyTorch: the stream (ids [C] or [R, C],
    rows [C, W] or [R, C, W]) settled ``group`` candidates at a time,
    bucket by bucket.  A pass takes the group's undecided valid
    candidates and computes for each its gain against the cover (U, an
    upper bound) and against the cover ORed with the rows of the earlier
    ones (L, a lower bound).  In arrival order a candidate is skipped
    once the bucket is full, rejected if float(U) < t, accepted if
    float(L) >= t (the pass's first candidate: its bounds are exact);
    the first other one is ambiguous, and the next pass starts there
    after the rows accepted so far join the cover.  A full bucket
    stops.  Returns (covers, counts, seeds) as :func:`bucket_insert_plain`
    and stats int32 [B, 4]: the passes, the ambiguous candidates, the
    index of the candidate that filled the bucket (-1: it never filled)
    and the rows the passes read."""
    ids = seed_ids.reshape(-1).tolist()
    rows = rows.reshape(len(ids), -1)
    covers, counts, seeds = covers.clone(), counts.clone(), seeds.clone()
    b_total, k = seeds.shape
    stats = torch.zeros((b_total, 4), dtype=torch.int32)
    stats[:, 2] = -1
    for b in range(b_total):
        cov, count, t = covers[b], int(counts[b]), thresholds[b]
        passes = ambiguous = rows_read = 0
        for g0 in range(0, len(ids), group):
            if count >= k:
                break
            live = [n for n in range(g0, min(g0 + group, len(ids)))
                    if ids[n] >= 0]
            while live:
                passes += 1
                rows_read += len(live)
                sub = rows[live]
                prior = torch.zeros_like(sub)      # exclusive OR scan
                for j in range(1, len(live)):
                    prior[j] = prior[j - 1] | sub[j - 1]
                upper = bitset.marginal_gain(sub, cov).to(torch.float32)
                lower = bitset.marginal_gain(sub, cov | prior).to(
                    torch.float32)
                reject, accept = (upper < t).tolist(), (lower >= t).tolist()
                rest, live, taken = live, [], []
                for j, n in enumerate(rest):
                    if count >= k:
                        break
                    if accept[j]:
                        seeds[b, count] = ids[n]
                        taken.append(j)
                        count += 1
                        if count == k:
                            stats[b, 2] = n
                    elif j and not reject[j]:
                        live = rest[j:]
                        ambiguous += 1
                        break
                if taken:
                    cov = cov | bitset.or_reduce(sub[taken], 0)
        covers[b], counts[b] = cov, count
        stats[b, 0], stats[b, 1], stats[b, 3] = passes, ambiguous, rows_read
    return covers, counts, seeds, stats


def bucket_insert_with_stats(seed_ids, rows, covers, counts, seeds,
                             thresholds):
    """The launch under :func:`bucket_insert_chunk` (ids [C]) or
    :func:`bucket_insert_stream` (ids [R, C]), counted under its name,
    with its figures returned: (covers, counts, seeds, stats int32
    [B, 6] by :data:`STATS`).  On the CPU:
    :func:`bucket_insert_grouped_plain` at :data:`GROUP`, one block a
    bucket."""
    if not ops.on_card(seed_ids, rows, covers, counts, seeds, thresholds):
        *state, st = bucket_insert_grouped_plain(
            seed_ids, rows, covers, counts, seeds, thresholds, GROUP)
        one = torch.ones_like(st[:, :1])
        return (*state, torch.cat([st, one * GROUP, one], 1))
    return _settle(seed_ids, rows, covers, counts, seeds, thresholds, True)


def _settle(seed_ids, rows, covers, counts, seeds, thresholds,
            with_stats=False):
    """Check the inputs and launch ``bucket_insert`` (ids [C]) or
    ``bucket_insert_stream`` (ids [R, C]) -> (covers, counts, seeds,
    stats or None)."""
    stream = seed_ids.dim() == 2
    b, w = covers.shape
    k = seeds.shape[1]
    ops.check(seed_ids, "seed_ids", torch.int32, (None,) * seed_ids.dim())
    ops.check(rows, "rows", torch.int32, (*seed_ids.shape, w))
    ops.check(covers, "covers", torch.int32, (b, w))
    ops.check(counts, "counts", torch.int32, (b,))
    ops.check(seeds, "seeds", torch.int32, (b, k))
    ops.check(thresholds, "thresholds", torch.float32, (b,))
    covers_out = torch.empty_like(covers)
    counts_out = torch.empty_like(counts)
    seeds_out = torch.empty_like(seeds)
    stats = (torch.empty((b, len(STATS)), dtype=torch.int32,
                         device=covers.device) if with_stats else None)
    if b == 0:
        return covers_out, counts_out, seeds_out, stats
    name = "bucket_insert_stream" if stream else "bucket_insert"
    ops.launch(name, "bucket_insert", name,
               _STREAM_ARGS if stream else _ARGS, seed_ids.data_ptr(),
               rows.data_ptr(), thresholds.data_ptr(), covers.data_ptr(),
               counts.data_ptr(), seeds.data_ptr(), covers_out.data_ptr(),
               counts_out.data_ptr(), seeds_out.data_ptr(),
               0 if stats is None else stats.data_ptr(), b,
               *seed_ids.shape, w, k)
    return covers_out, counts_out, seeds_out, stats


def stream_chunk_capacity(num_words: int, device) -> int:
    """The largest count of candidates whose double buffer ([2, C, W]
    words) fits the stream kernel's shared memory next to one cover (0
    when none does), asked of the CUDA ``device``."""
    with torch.cuda.device(device):
        return int(build.function("bucket_insert", "stream_chunk_capacity",
                                  [ops.I64])(num_words))


# The pipelined receiver's chunk size: ``smem_budget``'s model.
auto_chunk_size = smem_budget.auto_chunk_size
