"""The configurations' graphs, made from the seed on the host.

A configuration names its generator, ``graphs/<generator>.py``, whose
``edges(config, rng)`` returns the undirected edges ``(a, b)`` (int64
arrays) and the vertex count.  Each edge becomes an arc both ways,
stored as the reverse CSR that both the program and the reference read:
the in-arcs of each vertex in arc order (stable by destination).  Each
arc gets an IC probability U[0, p_max) (GreediRIS §4.1: p_max = 0.1)
and an LT weight U[0.1, 1) normalized over its head's in-arcs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from portbench import lookup


class Arrays(NamedTuple):
    indptr: np.ndarray     # int64 [n + 1]
    indices: np.ndarray    # int64 [arcs] source of each in-arc
    probs: np.ndarray      # float32 [arcs]
    weights: np.ndarray    # float32 [arcs]

    @property
    def n(self) -> int:
        return int(self.indptr.shape[0]) - 1


def both_ways(a: np.ndarray, b: np.ndarray, n: int, rng,
              p_max: float = 0.1) -> Arrays:
    """The reverse CSR of the undirected edges (a, b), each an arc both
    ways, with its probabilities and weights drawn from ``rng``."""
    src = np.concatenate([a, b])
    dst = np.concatenate([b, a])
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    deg = np.bincount(dst, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    probs = rng.uniform(0.0, p_max, size=src.shape[0]).astype(np.float32)
    raw = rng.uniform(0.1, 1.0, size=src.shape[0])
    row_sum = np.bincount(dst, weights=raw, minlength=n)
    weights = (raw / np.maximum(row_sum[dst], 1e-12)).astype(np.float32)
    return Arrays(indptr, src, probs, weights)


def make(config: dict) -> Arrays:
    """The graph a configuration names, from its ``graph_seed``: the
    deployment's data, fixed as a published file would be, so that every
    run's seed draws its samples, keys and queries over the same graph."""
    rng = np.random.default_rng([int(config["graph_seed"]), 0x6A])
    a, b, n = lookup.module("graphs", config["generator"]).edges(config,
                                                                  rng)
    return both_ways(a, b, n, rng, config["p_max"])
