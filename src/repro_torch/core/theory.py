"""Approximation-ratio and sampling-effort formulas.

Implements (a) the IMM sampling-effort machinery of Tang et al. [8]
(lambda', lambda*, martingale round thresholds) with Chen's [19]
corrected union bound, and (b) the GreediRIS approximation ratios of
Lemmas 3.1-3.3.
"""
from __future__ import annotations

import math


def log_binom(n: int, k: int) -> float:
    """log C(n, k) via lgamma."""
    k = min(k, n)
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1))


def lambda_prime(n: int, k: int, eps: float, ell: float) -> float:
    """lambda' of IMM (sampling effort per martingale round)."""
    eps_p = math.sqrt(2.0) * eps
    return ((2.0 + 2.0 * eps_p / 3.0)
            * (log_binom(n, k) + ell * math.log(n) +
               math.log(max(math.log2(max(n, 2)), 1.0)))
            * n / (eps_p ** 2))


def lambda_star(n: int, k: int, eps: float, ell: float) -> float:
    """lambda* of IMM (final sampling effort given LB on OPT)."""
    alpha = math.sqrt(ell * math.log(n) + math.log(2.0))
    beta = math.sqrt((1.0 - 1.0 / math.e)
                     * (log_binom(n, k) + ell * math.log(n) + math.log(2.0)))
    return 2.0 * n * ((1.0 - 1.0 / math.e) * alpha + beta) ** 2 / (eps ** 2)


def adjust_ell(n: int, k: int, ell: float) -> float:
    """Chen's fix: inflate ell so the union bound over martingale
    rounds still yields overall success probability 1 - 1/n^ell."""
    return ell * (1.0 + math.log(2.0) / math.log(max(n, 2)))


# ---------- GreediRIS guarantees (Lemmas 3.1-3.3) ----------

def randgreedi_ratio(alpha: float, beta: float) -> float:
    """Theorem 3.1: RandGreedi with alpha-approx local and beta-approx
    global solvers is alpha*beta/(alpha+beta)-approximate."""
    return alpha * beta / (alpha + beta)


def greedy_alpha() -> float:
    return 1.0 - 1.0 / math.e


def streaming_beta(delta: float) -> float:
    return 0.5 - delta


def truncated_alpha(alpha_trunc: float) -> float:
    """Lemma 3.2: truncated greedy sending alpha*k seeds is
    (1 - e^{-alpha})-approximate."""
    return 1.0 - math.exp(-alpha_trunc)


def greediris_ratio(delta: float, eps: float,
                    alpha_trunc: float = 1.0) -> float:
    """Lemma 3.1 / 3.3 worst-case expected approximation ratio."""
    a = truncated_alpha(alpha_trunc) if alpha_trunc < 1.0 else greedy_alpha()
    b = streaming_beta(delta)
    return randgreedi_ratio(a, b) - eps


def ripples_ratio(eps: float) -> float:
    return 1.0 - 1.0 / math.e - eps
