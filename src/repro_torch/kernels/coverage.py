"""Marginal gains of every row against a cover, per machine
(``csrc/coverage.cu``), and the plain PyTorch version.

Replaces ``repro/kernels/coverage.py``: ``marginal_gain_pallas`` (TPU
kernel #8), with a leading machine axis — the Ripples round sweeps all
m machines' rows in one launch per pick.  Bound on the H100: bytes (the
rows, read once).
"""
from __future__ import annotations

import torch

from repro_torch.core import bitset
from repro_torch.kernels import ops

# The contract checker's declaration (``repro_torch/analysis/contracts.py``):
# one sweep a Ripples pick.
CONTRACT = dict(
    family="coverage",
    dtypes=("bool", "int32", "int64"),
    variants=dict(ripples=dict(launches={"coverage": 1}, per_step=True)),
)

_ARGS = [ops.PTR] * 3 + [ops.I64] * 3


def marginal_gain_plain(rows: torch.Tensor, covered: torch.Tensor):
    """rows int32 [m, n, W], covered int32 [m, W] -> int32 [m, n]; one
    machine at a time, which bounds the int64 popcount temporaries."""
    m, n, _ = rows.shape
    out = torch.empty((m, n), dtype=torch.int32, device=rows.device)
    for j in range(m):
        out[j] = bitset.marginal_gain(rows[j], covered[j])
    return out


def marginal_gain(rows: torch.Tensor, covered: torch.Tensor) -> torch.Tensor:
    """gains[m, v] = sum_w popcount(rows[m, v, w] & ~covered[m, w])."""
    if not ops.on_card(rows, covered):
        return marginal_gain_plain(rows, covered)
    m, n, w = rows.shape
    ops.check(rows, "rows", torch.int32, (m, n, w))
    ops.check(covered, "covered", torch.int32, (m, w))
    gains = torch.zeros((m, n), dtype=torch.int32, device=rows.device)
    if m * n == 0:
        return gains
    ops.launch("coverage", "coverage", "coverage", _ARGS, rows.data_ptr(),
               covered.data_ptr(), gains.data_ptr(), m, n, w)
    return gains
