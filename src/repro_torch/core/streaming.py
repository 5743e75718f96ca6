"""Bucketed streaming max-k-cover (paper Algorithm 5, McGregor-Vu) —
twin of ``repro.core.streaming``.

B = ceil(log_{1+delta} k) threshold buckets; bucket b guesses
OPT ~ l*(1+delta)^b and admits a streamed candidate whose marginal gain
against the bucket's cover reaches guess_b / (2k), while it holds fewer
than k seeds.  Three receivers give bit-identical ``StreamState``:

  * ``"scan"`` — plain PyTorch, one candidate at a time;
  * ``"fused"`` — the whole chunk in one launch of the
    ``kernels.bucket_insert`` CUDA kernel;
  * ``"pipelined"`` — the stream cut into chunks of ``chunk_size``
    candidates, all of them in one launch of the stream kernel
    (``insert_stream``), the next chunk staged while one inserts.

The float32 thresholds are computed on the host, in the reference's
order of float32 operations (see :func:`thresholds`), so the admission
comparisons agree bit for bit.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.kernels import bucket_insert

RECEIVERS = ("scan", "fused", "pipelined")


class StreamState(NamedTuple):
    covers: torch.Tensor      # int32 [B, W] running union per bucket
    counts: torch.Tensor      # int32 [B] seeds admitted per bucket
    seeds: torch.Tensor       # int32 [B, k] admitted seed ids (-1 pad)
    thresholds: torch.Tensor  # float32 [B] admission threshold guess_b/(2k)


def num_buckets(k: int, delta: float) -> int:
    """B = ceil(log_{1+delta} (u/l)) with u/l = k (paper §3.4)."""
    return max(1, math.ceil(math.log(max(k, 2)) / math.log1p(delta)))


_libm = None


def _powf(x: np.float32, y: np.float32) -> np.float32:
    """C ``powf``: the function XLA's CPU backend calls for a float32
    ``power``; numpy's and torch's float32 pow round differently."""
    global _libm
    if _libm is None:
        _libm = ctypes.CDLL(ctypes.util.find_library("m"))
        _libm.powf.restype = ctypes.c_float
        _libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return np.float32(_libm.powf(float(x), float(y)))


def thresholds(k: int, delta: float, lower: float, b: int) -> np.ndarray:
    """float32 [b] = lower * (1 + delta)^i / (2k), as the reference's
    jitted ``init_state`` evaluates it on the CPU: float32 ``powf``, a
    float32 product, and the division folded into a product with the
    float32 reciprocal of 2k."""
    base = np.float32(1.0 + delta)
    pows = np.array([_powf(base, np.float32(i)) for i in range(b)],
                    dtype=np.float32)
    recip = np.float32(1.0) / np.float32(2.0 * k)
    return (np.float32(lower) * pows) * recip


def init_state(k: int, delta: float, lower: float, num_words: int,
               num_buckets_override: int | None = None, *,
               device="cuda") -> StreamState:
    if num_buckets_override is None:
        b = num_buckets(k, delta)
    else:
        if num_buckets_override < 1:
            raise ValueError(
                f"num_buckets_override must be >= 1 (at least one "
                f"threshold bucket), got {num_buckets_override}")
        b = num_buckets_override
    thr = torch.from_numpy(thresholds(k, delta, float(lower), b))
    return StreamState(
        covers=torch.zeros((b, num_words), dtype=torch.int32, device=device),
        counts=torch.zeros((b,), dtype=torch.int32, device=device),
        seeds=torch.full((b, k), -1, dtype=torch.int32, device=device),
        thresholds=thr.to(device),
    )


def insert_chunk(state: StreamState, seed_ids: torch.Tensor,
                 rows: torch.Tensor, k: int,
                 use_kernel: bool = False) -> StreamState:
    """Stream a chunk of candidates (ids [C], rows [C, W]) through all
    buckets in arrival order; ``use_kernel`` picks the fused kernel."""
    if k != state.seeds.shape[1]:
        raise ValueError(
            f"k={k} does not match the state's bucket capacity "
            f"{state.seeds.shape[1]} (seeds.shape[1])")
    fn = (bucket_insert.bucket_insert_chunk if use_kernel
          else bucket_insert.bucket_insert_plain)
    covers, counts, seeds = fn(seed_ids.to(torch.int32).contiguous(),
                               rows.contiguous(), state.covers, state.counts,
                               state.seeds, state.thresholds)
    return StreamState(covers, counts, seeds, state.thresholds)


def insert_stream(state: StreamState, seed_ids: torch.Tensor,
                  rows: torch.Tensor, k: int,
                  use_kernel: bool = True) -> StreamState:
    """Stream a chunked candidate stream (ids [R, C], rows [R, C, W])
    through all buckets in arrival order (chunk by chunk): one launch of
    the stream kernel with ``use_kernel``, else the scan folded over the
    chunks.  Bit-identical to streaming the [R * C] candidates one by
    one."""
    if k != state.seeds.shape[1]:
        raise ValueError(
            f"k={k} does not match the state's bucket capacity "
            f"{state.seeds.shape[1]} (seeds.shape[1])")
    if seed_ids.dim() != 2 or rows.dim() != 3:
        raise ValueError(
            f"insert_stream takes a chunked stream: ids [R, C] and rows "
            f"[R, C, W]; got ids {tuple(seed_ids.shape)} and rows "
            f"{tuple(rows.shape)} — use insert_chunk for a flat chunk")
    fn = (bucket_insert.bucket_insert_stream if use_kernel
          else bucket_insert.bucket_insert_stream_plain)
    covers, counts, seeds = fn(seed_ids.to(torch.int32).contiguous(),
                               rows.contiguous(), state.covers, state.counts,
                               state.seeds, state.thresholds)
    return StreamState(covers, counts, seeds, state.thresholds)


def chunk_stream(seed_ids: torch.Tensor, rows: torch.Tensor,
                 chunk_size: int):
    """Reshape a flat candidate stream (ids [T], rows [T, W]) into
    [R, C] / [R, C, W] chunks, padding the tail with id -1 / zero rows
    (rejected unconditionally, so exactness is preserved)."""
    total = seed_ids.shape[0]
    pad = (-total) % chunk_size
    if pad:
        seed_ids = torch.cat([seed_ids, seed_ids.new_full((pad,), -1)])
        rows = torch.cat([rows, rows.new_zeros((pad, rows.shape[1]))])
    nch = (total + pad) // chunk_size
    return (seed_ids.reshape(nch, chunk_size),
            rows.reshape(nch, chunk_size, rows.shape[1]))


def finalize(state: StreamState):
    """(seeds [k], coverage) of the best (argmax-cover) bucket; raises if
    a bucket holds more admissions than seed slots."""
    k = state.seeds.shape[1]
    top = int(state.counts.max())
    if top > k:
        raise ValueError(f"bucket overfilled: max count {top} > capacity k={k}")
    per_bucket = bitset.coverage_size(state.covers)
    best = torch.argmax(per_bucket)
    return state.seeds[best], per_bucket[best]


def streaming_maxcover(seed_ids: torch.Tensor, rows: torch.Tensor, k: int,
                       delta: float, lower: float,
                       num_buckets_override: int | None = None,
                       use_kernel: bool = False, receiver: str | None = None,
                       chunk_size: int | None = None):
    """One streaming pass over an ordered candidate stream; ``lower`` is
    the max singleton coverage.  Returns (seeds [k], coverage [], state).
    ``receiver`` is "scan", "fused" or "pipelined" (default from
    ``use_kernel``); the pipelined receiver cuts the stream into
    ``chunk_size`` candidates (None: ``bucket_insert.auto_chunk_size``)."""
    if receiver is None:
        receiver = "fused" if use_kernel else "scan"
    if receiver not in RECEIVERS:
        raise ValueError(f"unknown receiver path {receiver!r}")
    state = init_state(k, delta, lower, rows.shape[1], num_buckets_override,
                       device=rows.device)
    total = seed_ids.shape[0]
    if total and receiver == "pipelined":
        cs = min(chunk_size or bucket_insert.auto_chunk_size(
            rows.shape[1], total, rows.device), total)
        state = insert_stream(state, *chunk_stream(seed_ids, rows, cs), k)
    elif total:
        state = insert_chunk(state, seed_ids, rows, k,
                             use_kernel=(receiver == "fused"))
    seeds, cov = finalize(state)
    return seeds, cov, state
