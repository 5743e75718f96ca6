"""OPIM-C (Tang et al.) for GreediRIS — twin of ``repro.core.opim``.

Each round's samples split into R1 (selection) and R2 (validation):
the seeds are selected on R1, their influence is lower-bounded on R2
by a Chernoff-style bound, and OPT is upper-bounded by R1's greedy
coverage over the solver's approximation factor.  Rounds double the
samples until the certified ratio reaches the target or ``max_theta``.
The bounds are float64 host math, equal to the reference's floats.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import StageClock, bitset
from repro_torch.core.imm import Selector, _round32, make_greedy_selector
from repro_torch.core.prng import Key
from repro_torch.core.rrr import (graph_tables, resolve_sampler,
                                  sample_incidence)
from repro_torch.graphs.csr import CSRGraph


class OPIMResult(NamedTuple):
    seeds: np.ndarray
    guarantee: float        # certified instance-wise approximation ratio
    sigma_lower: float      # certified lower bound on sigma(S)
    sigma_upper_opt: float  # certified upper bound on sigma(OPT)
    theta: int              # samples per half (R1 = R2 = theta)
    rounds: int


def _sigma_lower(cov: float, theta: int, n: int, delta: float) -> float:
    """Lower bound on sigma(S) from coverage ``cov`` on R2."""
    a = math.log(1.0 / delta)
    val = (math.sqrt(cov + 2.0 * a / 9.0) - math.sqrt(a / 2.0)) ** 2 \
        - a / 18.0
    return max(val, 0.0) * n / theta


def _sigma_upper(cov_ub: float, theta: int, n: int, delta: float) -> float:
    """Upper bound on sigma(OPT) from an upper bound on OPT's coverage."""
    a = math.log(1.0 / delta)
    return (math.sqrt(cov_ub + a / 2.0) + math.sqrt(a / 2.0)) ** 2 \
        * n / theta


def certify(cov_sel: float, cov_val: float, theta: int, n: int,
            delta: float, alpha: float) -> tuple[float, float, float]:
    """(sigma_lower, sigma_upper_opt, guarantee) of seeds whose coverage
    is ``cov_sel`` on R1 and ``cov_val`` on R2; ``alpha`` is the
    solver's approximation factor.  Shared by the OPIM loop and the
    serving admission rule (``core.service``)."""
    sig_l = _sigma_lower(cov_val, theta, n, delta)
    sig_u = _sigma_upper(cov_sel / alpha, theta, n, delta)
    return sig_l, sig_u, sig_l / max(sig_u, 1e-9)


def coverage_on(rows: torch.Tensor, seeds: torch.Tensor) -> int:
    """Coverage of the valid (>= 0) ids of ``seeds`` on packed ``rows``."""
    seeds = seeds[seeds >= 0].long()
    return int(bitset.coverage_size(bitset.or_reduce(rows[seeds], axis=0)))


def opim(g: CSRGraph, k: int, eps: float, key: Key, *, model: str = "IC",
         selector: Optional[Selector] = None,
         solver_alpha: Optional[float] = None,
         theta0: int = 256, max_theta: int = 1 << 16, max_steps: int = 32,
         fail_prob: float = 1.0 / 128.0, solver: str | None = None,
         sampler: str = "kernel", coin_chunk: int = 32, gather: str = "auto",
         stats: Optional[dict] = None) -> OPIMResult:
    """OPIM-C on the graph's device.  ``solver_alpha`` (default the
    greedy 1 - 1/e) bounds OPT; ``solver`` picks the default greedy
    selector's path and is ignored when ``selector`` is given.
    ``stats`` (optional dict) accumulates ``bfs_steps``, ``sample_s``
    and ``select_s``."""
    selector = selector or make_greedy_selector(solver)
    sampler = resolve_sampler(sampler)
    if solver_alpha is None:
        solver_alpha = 1.0 - 1.0 / math.e
    n = g.num_vertices
    nbr, prob, wt, fwd, lt = graph_tables(g, sampler, gather, model)
    target = solver_alpha - eps
    i_max = max(1, int(math.ceil(math.log2(max_theta / max(theta0, 1)))) + 1)
    delta = fail_prob / (3.0 * i_max)

    def sample(sub, count):
        with StageClock(stats, "sample_s", g.device):
            return sample_incidence(
                nbr, prob, wt, sub, theta=count, n=n, model=model,
                max_steps=max_steps, sampler=sampler, fwd=fwd,
                coin_chunk=coin_chunk, gather=gather, stats=stats, lt=lt)

    r1 = r2 = None
    theta = 0
    result = None
    for i in range(i_max):
        new_theta = min(_round32(theta0 * (2 ** i)), max_theta)
        add = new_theta - theta
        if add > 0:
            inc1 = sample(key.fold_in(2 * i), add)
            inc2 = sample(key.fold_in(2 * i + 1), add)
            r1 = inc1 if r1 is None else torch.cat([r1, inc1], 1)
            r2 = inc2 if r2 is None else torch.cat([r2, inc2], 1)
            theta = new_theta
        with StageClock(stats, "select_s", g.device):
            seeds, cov1 = selector(r1, k, key.fold_in(0xA0 + i))
            cov2 = coverage_on(r2, seeds)
        sig_l, sig_u, guar = certify(float(cov1), float(cov2), theta, n,
                                     delta, solver_alpha)
        result = OPIMResult(seeds.cpu().numpy(), guar, sig_l, sig_u, theta,
                            i + 1)
        if guar >= target or theta >= max_theta:
            break
    return result
