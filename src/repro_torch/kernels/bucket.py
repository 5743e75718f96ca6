"""Gains of one candidate row against B bucket covers
(``csrc/bucket_gains.cu``) and the plain PyTorch version.

Replaces ``repro/kernels/bucket.py``: ``bucket_gains_pallas`` (TPU
kernel #9), the legacy receiver's per-candidate gain pass.  It lies on
no path of the reference (the chunk and stream receivers fuse it);
``repro/kernels/ops.py:33`` exposes it as a public op, and so does this
module.  The kernel splits each bucket's words over a cluster of S
blocks (:func:`cluster_size`) whose first block adds the others' sums
through distributed shared memory.  Bound on the H100: bytes (the covers
and the row read once).
"""
from __future__ import annotations

import torch

from repro_torch.core import bitset
from repro_torch.kernels import build, ops

# The contract checker's declaration (``repro_torch/analysis/contracts.py``).
CONTRACT = dict(
    family="bucket",
    dtypes=("int32", "int64"),
    variants=dict(gains=dict(launches={"bucket_gains": 1})),
)

_ARGS = [ops.PTR] * 3 + [ops.I64] * 2
# The cluster rule of ``csrc/bucket_gains.cu``: at most the portable
# cluster size, and a slice of at least this many loads a block.
MAX_CLUSTER = 8
MIN_SLICE_UNITS = 128


def bucket_gains_plain(row: torch.Tensor, covers: torch.Tensor):
    """gains[b] = sum_w popcount(row[w] & ~covers[b, w]), int32 [B]."""
    return bitset.coverage_size(row[None] & ~covers)


def bucket_gains(row: torch.Tensor, covers: torch.Tensor) -> torch.Tensor:
    """row int32 [W], covers int32 [B, W] -> int32 [B] gains."""
    b, w = covers.shape
    if not ops.on_card(row, covers):
        return bucket_gains_plain(row, covers)
    ops.check(row, "row", torch.int32, (w,))
    ops.check(covers, "covers", torch.int32, (b, w))
    if b == 0 or w == 0:
        return torch.zeros((b,), dtype=torch.int32, device=covers.device)
    gains = torch.empty((b,), dtype=torch.int32, device=covers.device)
    ops.launch("bucket_gains", "bucket_gains", "bucket_gains", _ARGS,
               row.data_ptr(), covers.data_ptr(), gains.data_ptr(), b, w)
    return gains


def cluster_size(b: int, w: int, vec: bool, sms: int) -> int:
    """The blocks a bucket of the launch for B buckets of W words on a
    card of ``sms`` SMs: the least power of two S with B x S >= 2 x sms,
    at most :data:`MAX_CLUSTER`, halved while a block's slice would hold
    fewer than :data:`MIN_SLICE_UNITS` loads (16 bytes each with
    ``vec``: the row and the covers 16-byte aligned and W a multiple of
    4; else 4)."""
    units = w // 4 if vec else w
    s = 1
    while s < MAX_CLUSTER and b * s < 2 * sms:
        s *= 2
    while s > 1 and units < s * MIN_SLICE_UNITS:
        s //= 2
    return s


def launch_cluster(b: int, w: int, vec: bool, device) -> int:
    """:func:`cluster_size` as the C side computes it on the CUDA
    ``device``."""
    with torch.cuda.device(device):
        return int(build.function("bucket_gains", "bucket_gains_cluster",
                                  [ops.I64] * 3)(b, w, int(vec)))
