"""What the timed path's work needs at the least, and the H100's rates
that turn it into a bound in seconds.

Each count is computed from the inputs and from the outputs the timed
path produced; a roofline share is a bound over a measured device time.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.cover import popcount

# H100 SXM HBM3 peak bandwidth (published).
HBM_BYTES_PER_S = 3.35e12
# INT32 peak: 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock (derived
# from the SM's lane count: NVIDIA publishes no INT32 rate).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Integer operations a coin takes: threefry's 20 x (add, rotate, xor)
# plus its key injections, the float conversion and the compare
# (counted, not measured).
OPS_PER_COIN = 80
WORD_BYTES = 4


def live_slots(indptr: np.ndarray, probs: np.ndarray) -> np.ndarray:
    """int64 [n]: the in-arcs of each vertex with p > 0 (the coins one
    visit of the vertex needs)."""
    n = indptr.shape[0] - 1
    head = np.repeat(np.arange(n), np.diff(indptr))
    return np.bincount(head[probs > 0], minlength=n).astype(np.int64)


def coins(rows: torch.Tensor, slots: torch.Tensor, block: int = 4096) -> int:
    """The coins an IC incidence needs: each (sample, vertex) it holds
    was expanded once, drawing a coin for each of the vertex's live
    in-arcs -> sum_v popcount(row v) * slots[v].  Exact while no sample
    reaches ``max_steps`` (a vertex reached at the last step is never
    expanded)."""
    total = 0
    for lo in range(0, rows.shape[0], block):
        per_row = popcount(rows[lo:lo + block].to(torch.int64)).sum(1)
        total += int((per_row * slots[lo:lo + block]).sum())
    return total


def sampler_bound_s(n_coins: int, incidence_bytes: int) -> float:
    """The larger of the coins over the INT32 rate and the incidence
    written once over the HBM rate."""
    return max(n_coins * OPS_PER_COIN / INT32_OPS_PER_S,
               incidence_bytes / HBM_BYTES_PER_S)


def select_bytes(rows: int, words: int, k: int) -> int:
    """One selector call: its incidence [rows, W] read once, its seeds
    and coverage written once."""
    return WORD_BYTES * (rows * words + k + 1)


def query_batch_bytes(n: int, words: int, batch: int, k: int,
                      excluded: int) -> int:
    """One query-axis launch: the pool half [n, W] read once; per query
    its exclusion list read, its cover, k seeds, k gains and k selected
    rows written once."""
    per_query = excluded + words + 2 * k + k * words
    return WORD_BYTES * (n * words + batch * per_query)


def bound_s(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S
