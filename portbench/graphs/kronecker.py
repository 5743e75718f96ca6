"""Graph500's Kronecker generator (graph500.org specification, "Graph
Generation"): ``edgefactor * 2^scale`` edges, each placed by ``scale``
draws of a quadrant of the initiator [[A, B], [C, D]] (D = 1 - A - B -
C), its bits set from the lowest, the vertex labels then permuted at
random.  The edge list is read as an undirected simple graph:
self-loops and repeated edges are dropped, as the specification allows
the graph's construction to.

Configuration keys: ``scale``, ``edgefactor``, ``A``, ``B``, ``C``.
"""
from __future__ import annotations

import numpy as np


def edges(config: dict, rng) -> tuple[np.ndarray, np.ndarray, int]:
    scale, n = int(config["scale"]), 1 << int(config["scale"])
    m = int(config["edgefactor"]) * n
    a, b, c = config["A"], config["B"], config["C"]
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    i = np.zeros(m, dtype=np.int64)
    j = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        i_bit = rng.random(m) > ab
        j_bit = rng.random(m) > np.where(i_bit, c_norm, a_norm)
        i |= i_bit.astype(np.int64) << bit
        j |= j_bit.astype(np.int64) << bit
    perm = rng.permutation(n)
    i, j = perm[i], perm[j]
    keep = i != j
    lo, hi = np.minimum(i[keep], j[keep]), np.maximum(i[keep], j[keep])
    code = np.unique(lo * n + hi)
    return code // n, code % n, n
