"""RandGreedi for max-k-cover (paper Algorithm 4) — twin of
``repro.core.randgreedi``.

Partition the covering sets uniformly at random over m machines, run
greedy on each machine (one batched solve over the machine axis),
aggregate the union of the local solutions on a global machine (offline
greedy or the streaming algorithm), and return the better of {global,
best local}.  Also the Ripples baseline (``ripples_select``): greedy
with one global reduction of the per-machine gains per pick.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitset, maxcover, span, streaming
from repro_torch.core.prng import Key
from repro_torch.kernels import coverage


class RandGreediResult(NamedTuple):
    seeds: torch.Tensor        # int32 [k] global vertex ids (-1 pad)
    coverage: torch.Tensor     # int32 []
    global_coverage: torch.Tensor
    best_local_coverage: torch.Tensor
    local_seeds: torch.Tensor  # int32 [m, k] global ids of local picks
    covered: torch.Tensor      # int32 [W] union of the winning branch


def partition_permutation(n: int, key: Key, *, device) -> torch.Tensor:
    """Uniform random partition = random permutation chopped into m blocks."""
    return key.permutation(n, device=device)


def partition_blocks(n: int, m: int, key: Key) -> np.ndarray:
    """The [m, n // m] partition of :func:`randgreedi_maxcover` for
    ``(n, m, key)`` — machine j's block is row j."""
    perm = partition_permutation(n, key, device="cpu").numpy()
    per = n // m
    return perm[:per * m].reshape(m, per)


def normalize_survivors(survivors, m: int):
    if survivors is None:
        return None
    surv = tuple(sorted({int(j) for j in survivors}))
    if not surv:
        raise ValueError("survivors must name at least one machine")
    if surv[0] < 0 or surv[-1] >= m:
        raise ValueError(f"survivor ids must be in [0, {m}), got {surv}")
    if len(surv) == m:
        return None  # all alive — identical to the unmasked path
    return surv


def randgreedi_maxcover(rows: torch.Tensor, key: Key, *, m: int, k: int,
                        aggregator: str = "streaming", delta: float = 0.077,
                        alpha_trunc: float = 1.0, use_kernel: bool = False,
                        solver: str | None = None,
                        survivors=None) -> RandGreediResult:
    """RandGreedi max-k-cover over int32 rows [n, W].

    aggregator: "greedy" (offline greedy) or "streaming" (Alg. 5, the
      fused receiver kernel when ``use_kernel``).  alpha_trunc < 1 sends
      only the first round(alpha*k) local seeds (GreediRIS-trunc).
    solver: local (and greedy-aggregator) path, "scan" | "resident".
    survivors: surviving machine ids; only their blocks are solved and
      aggregated (bit-identical to a round on those machines alone).

    Its phases are the spans ``randgreedi.partition`` (the permutation
    and the machines' rows), ``.local`` (the machines' greedy),
    ``.receiver`` (the aggregation) and ``.merge`` (the final choice).
    """
    if aggregator not in ("greedy", "streaming"):
        raise ValueError(f"unknown aggregator {aggregator!r}")
    survivors = normalize_survivors(survivors, m)
    n, w = rows.shape
    with span("randgreedi.partition"):
        perm = partition_permutation(n, key, device=rows.device)
        per = n // m
        assign = perm[:per * m].reshape(m, per).long()
        if survivors is not None:
            assign = assign[list(survivors)]
        machine_rows = rows[assign]
    with span("randgreedi.local"):
        local = maxcover.greedy_maxcover(machine_rows, k, solver=solver)
        del machine_rows        # a copy of every row: freed before the receiver
        local_ids = torch.where(
            local.seeds >= 0,
            torch.gather(assign, 1, local.seeds.clamp(min=0).long()).to(
                torch.int32), -1)                           # [m, k]
        local_cov = local.coverage                          # [m]

    kk = max(1, int(round(alpha_trunc * k)))
    sent_ids = local_ids[:, :kk].reshape(-1)
    sent_rows = local.rows[:, :kk].reshape(-1, w)

    with span("randgreedi.receiver"):
        if aggregator == "greedy":
            sol = maxcover.greedy_maxcover(sent_rows, k, solver=solver)
            g_ids = torch.where(sol.seeds >= 0,
                                sent_ids[sol.seeds.clamp(min=0).long()], -1)
            g_cov, g_cover = sol.coverage, sol.covered
        else:
            # l = max singleton coverage among the stream: each
            # machine's first pick has its max.
            lower = float(local.gains[:, 0].max())
            g_ids, g_cov, state = streaming.streaming_maxcover(
                sent_ids, sent_rows, k, delta, lower, use_kernel=use_kernel)
            per_bucket = bitset.coverage_size(state.covers)
            g_cover = state.covers[torch.argmax(per_bucket)]

    with span("randgreedi.merge"):
        best_m = torch.argmax(local_cov)
        take_global = g_cov >= local_cov[best_m]
        seeds = torch.where(take_global, g_ids, local_ids[best_m])
        coverage = torch.maximum(g_cov, local_cov[best_m])
        covered = torch.where(take_global, g_cover, local.covered[best_m])
    return RandGreediResult(seeds, coverage, g_cov, local_cov.max(),
                            local_ids, covered)


def ripples_picks(x: torch.Tensor, k: int, use_kernel: bool = False):
    """k greedy picks over samples sharded by machine: x int32
    [m, n, w_local], machine j holding words of its own samples.  Each
    pick sums the machines' gains (the all-reduce GreediRIS removes),
    masks picked vertices to -1 and takes the lowest argmax; the gains
    come from the ``coverage`` kernel with ``use_kernel``.  Returns
    (seeds int32 [k], covered int32 [m, w_local])."""
    m, n, wl = x.shape
    dev = x.device
    gain = coverage.marginal_gain if use_kernel else \
        coverage.marginal_gain_plain
    covered = torch.zeros((m, wl), dtype=torch.int32, device=dev)
    seeds = torch.full((k,), -1, dtype=torch.int32, device=dev)
    picked = torch.zeros((n,), dtype=torch.bool, device=dev)
    for i in range(k):
        total = gain(x, covered).sum(0, dtype=torch.int32)
        total = torch.where(picked, -1, total)
        best = torch.argmax(total)
        take = total[best] > 0
        covered |= torch.where(take, x[:, best], 0)
        seeds[i] = torch.where(take, best.to(torch.int32), -1)
        picked[best] |= take
    return seeds, covered


def ripples_select(rows: torch.Tensor, *, m: int, k: int,
                   use_kernel: bool = False):
    """Ripples-style seed selection over rows int32 [n, W]: the words
    split into m machine shards of W // m (the tail words dropped, as
    the reference does), then :func:`ripples_picks` in plain PyTorch
    (``use_kernel`` is ignored, as in the reference).  Returns (seeds
    [k], coverage [])."""
    n, w = rows.shape
    wm = w // m
    shards = rows[:, :wm * m].reshape(n, m, wm).permute(1, 0, 2)
    seeds, covered = ripples_picks(shards.contiguous(), k)
    return seeds, bitset.coverage_size(covered).sum(dtype=torch.int32)
