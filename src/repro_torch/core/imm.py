"""IMM martingale-round driver (paper Algorithm 1, Tang et al.) — twin of
``repro.core.imm``.

A host loop (the number of rounds depends on the data) around the
sampling and seed-selection steps.  The selector is pluggable — greedy,
RandGreedi, or the streaming GreediRIS.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import StageClock, maxcover, randgreedi, span, theory
from repro_torch.core.prng import Key
from repro_torch.core.rrr import (graph_tables, resolve_sampler,
                                  sample_incidence)
from repro_torch.graphs.csr import CSRGraph

# selector(rows [n, W], k, key) -> (seeds [k] int32, coverage int32)
Selector = Callable[[torch.Tensor, int, Key], tuple]


class IMMResult(NamedTuple):
    seeds: np.ndarray
    coverage_fraction: float
    theta: int
    rounds: int
    lb: float


def make_greedy_selector(solver: str | None = None) -> Selector:
    def sel(rows, k, key):
        sol = maxcover.greedy_maxcover(rows, k, solver=solver)
        return sol.seeds, sol.coverage
    return sel


def make_randgreedi_selector(m: int, aggregator: str = "streaming",
                             delta: float = 0.077,
                             alpha_trunc: float = 1.0,
                             use_kernel: bool = False,
                             solver: str | None = None) -> Selector:
    def sel(rows, k, key):
        n = rows.shape[0]
        pad = (-n) % m
        if pad:
            rows = torch.nn.functional.pad(rows, (0, 0, 0, pad))
        res = randgreedi.randgreedi_maxcover(
            rows, key, m=m, k=k, aggregator=aggregator, delta=delta,
            alpha_trunc=alpha_trunc, use_kernel=use_kernel, solver=solver)
        seeds = torch.where(res.seeds < n, res.seeds, -1)
        return seeds, res.coverage
    return sel


def make_ripples_selector(m: int) -> Selector:
    def sel(rows, k, key):
        return randgreedi.ripples_select(rows, m=m, k=k)
    return sel


def _round32(x: float) -> int:
    return int(math.ceil(x / 32.0) * 32)


def imm(g: CSRGraph, k: int, eps: float, key: Key, *, model: str = "IC",
        ell: float = 1.0, selector: Optional[Selector] = None,
        max_theta: int = 1 << 16, max_steps: int = 32,
        theta0: Optional[int] = None, solver: str | None = None,
        sampler: str = "kernel", coin_chunk: int = 32, gather: str = "auto",
        stats: Optional[dict] = None) -> IMMResult:
    """Run IMM on the graph's device and return the final seed set.

    ``stats`` (optional dict) accumulates the seconds spent sampling
    (``sample_s``) and selecting (``select_s``), and the sampler's
    counters (``bfs_steps``, ``frontier_words``, and on the LT push
    ``frontier_bits``, ``root_bits``, ``choice_reads``;
    :func:`rrr.rrr_batch_packed`).  The graph's tables are built once a
    call, only those the sampler path reads (:func:`rrr.graph_tables`).
    Each martingale round is the span ``imm.round`` and the final
    sampling and selection ``imm.final``, with ``imm.sample`` and
    ``imm.select`` inside them.
    """
    selector = selector or make_greedy_selector(solver)
    sampler = resolve_sampler(sampler)
    n = g.num_vertices
    nbr, prob, wt, fwd, lt = graph_tables(g, sampler, gather, model)
    ell = theory.adjust_ell(n, k, ell)
    lp = theory.lambda_prime(n, k, eps, ell)
    eps_p = math.sqrt(2.0) * eps

    def sample(sub, count):
        with StageClock(stats, "sample_s", g.device, layer="imm"):
            return sample_incidence(
                nbr, prob, wt, sub, theta=count, n=n, model=model,
                max_steps=max_steps, sampler=sampler, fwd=fwd,
                coin_chunk=coin_chunk, gather=gather, stats=stats, lt=lt)

    def select(sub):
        with StageClock(stats, "select_s", g.device, layer="imm"):
            seeds, cov = selector(rows, k, sub)
            return seeds, int(cov)

    rows = None
    theta_cur = 0
    lb = 1.0
    rounds = 0
    k_sel = key.fold_in(0xC0FFEE)

    max_rounds = max(1, int(math.log2(max(n, 2))))
    for i in range(1, max_rounds + 1):
        rounds = i
        x = n / (2.0 ** i)
        theta_i = min(_round32(lp / x), max_theta)
        if theta0 is not None and i == 1:
            theta_i = max(theta_i, _round32(theta0))
        add = theta_i - theta_cur
        with span("imm.round"):
            if add > 0:
                inc = sample(key.fold_in(i), add)
                rows = inc if rows is None else torch.cat([rows, inc], 1)
                theta_cur = theta_i
            seeds, cov = select(k_sel.fold_in(i))
        frac = float(cov) / float(theta_cur)
        if n * frac >= (1.0 + eps_p) * x or theta_cur >= max_theta:
            lb = max(n * frac / (1.0 + eps_p), 1.0)
            break

    theta = min(_round32(theory.lambda_star(n, k, eps, ell) / lb), max_theta)
    with span("imm.final"):
        if theta > theta_cur:
            inc = sample(key.fold_in(0x5EED), theta - theta_cur)
            rows = torch.cat([rows, inc], 1)
            theta_cur = theta
        seeds, cov = select(k_sel.fold_in(0x5EED))
    return IMMResult(seeds.cpu().numpy(), float(cov) / theta_cur, theta_cur,
                     rounds, lb)
