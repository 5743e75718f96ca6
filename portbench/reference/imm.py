"""IMM's martingale rounds (Tang et al., with Chen's corrected union
bound), as plain host arithmetic around a selector.

Round i asks for theta_i = min(ceil32(lambda' 2^i / n), max_theta)
samples, drawn (the ones beyond the last round's) under ``key.fold_in(i)``
and selected under ``key.fold_in(0xC0FFEE).fold_in(i)``; the rounds stop
at the first whose coverage certifies n * frac >= (1 + sqrt(2) eps) n /
2^i, or that reaches max_theta, and set LB from it.  The final theta is
min(ceil32(lambda* / LB), max_theta), its new samples drawn under
``key.fold_in(0x5EED)`` and selected under ``key.fold_in(0xC0FFEE)
.fold_in(0x5EED)``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

from portbench.reference.threefry import Key

FINAL = 0x5EED
SELECT = 0xC0FFEE


def log_binom(n: int, k: int) -> float:
    k = min(k, n)
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def lambda_prime(n: int, k: int, eps: float, ell: float) -> float:
    eps_p = math.sqrt(2.0) * eps
    return ((2.0 + 2.0 * eps_p / 3.0)
            * (log_binom(n, k) + ell * math.log(n)
               + math.log(max(math.log2(max(n, 2)), 1.0)))
            * n / (eps_p ** 2))


def lambda_star(n: int, k: int, eps: float, ell: float) -> float:
    alpha = math.sqrt(ell * math.log(n) + math.log(2.0))
    beta = math.sqrt((1.0 - 1.0 / math.e)
                     * (log_binom(n, k) + ell * math.log(n) + math.log(2.0)))
    return 2.0 * n * ((1.0 - 1.0 / math.e) * alpha + beta) ** 2 / (eps ** 2)


def adjust_ell(n: int, ell: float) -> float:
    return ell * (1.0 + math.log(2.0) / math.log(max(n, 2)))


def ceil32(x: float) -> int:
    return int(math.ceil(x / 32.0) * 32)


class Draw(NamedTuple):
    """Samples [start, start + count) of the incidence: samples 0 ..
    count - 1 of a draw under ``key``."""
    key: Key
    start: int
    count: int


class Call(NamedTuple):
    words: int          # the incidence's width at the call
    key: Key
    seeds: tuple
    coverage: int


class Result(NamedTuple):
    seeds: tuple
    coverage_fraction: float
    theta: int
    rounds: int
    lb: float


def imm(n: int, k: int, eps: float, key: Key, max_theta: int,
        select: Callable[[int, Key], tuple],
        on_draw: Callable[[Draw], None] = lambda d: None, ell: float = 1.0):
    """The rounds, with ``select(words, key) -> (seeds, coverage)`` over
    the first ``words`` words of the incidence, ``on_draw`` told of each
    draw before the selection that reads it -> (draws, calls,
    result)."""
    ell = adjust_ell(n, ell)
    lp = lambda_prime(n, k, eps, ell)
    eps_p = math.sqrt(2.0) * eps
    k_sel = key.fold_in(SELECT)
    draws, calls = [], []
    theta_cur, lb, rounds = 0, 1.0, 0

    def pick(sub: Key):
        seeds, cov = select(theta_cur // 32, sub)
        calls.append(Call(theta_cur // 32, sub, tuple(int(s) for s in seeds),
                          int(cov)))
        return calls[-1]

    for i in range(1, max(1, int(math.log2(max(n, 2)))) + 1):
        rounds = i
        x = n / (2.0 ** i)
        theta_i = min(ceil32(lp / x), max_theta)
        if theta_i > theta_cur:
            draws.append(Draw(key.fold_in(i), theta_cur, theta_i - theta_cur))
            on_draw(draws[-1])
            theta_cur = theta_i
        call = pick(k_sel.fold_in(i))
        frac = float(call.coverage) / float(theta_cur)
        if n * frac >= (1.0 + eps_p) * x or theta_cur >= max_theta:
            lb = max(n * frac / (1.0 + eps_p), 1.0)
            break
    theta = min(ceil32(lambda_star(n, k, eps, ell) / lb), max_theta)
    if theta > theta_cur:
        draws.append(Draw(key.fold_in(FINAL), theta_cur, theta - theta_cur))
        on_draw(draws[-1])
        theta_cur = theta
    call = pick(k_sel.fold_in(FINAL))
    return draws, calls, Result(call.seeds, float(call.coverage) / theta_cur,
                                theta_cur, rounds, lb)
