"""Gains of one candidate row against B bucket covers
(``csrc/bucket_gains.cu``) and the plain PyTorch version.

Replaces ``repro/kernels/bucket.py``: ``bucket_gains_pallas`` (TPU
kernel #9), the legacy receiver's per-candidate gain pass.  It lies on
no path of the reference (the chunk and stream receivers fuse it);
``repro/kernels/ops.py:33`` exposes it as a public op, and so does this
module.  Bound on the H100: bytes (the covers and the row read once).
"""
from __future__ import annotations

import torch

from repro_torch.core import bitset
from repro_torch.kernels import ops

_ARGS = [ops.PTR] * 3 + [ops.I64] * 2


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
