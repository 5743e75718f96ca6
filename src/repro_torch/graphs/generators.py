"""Synthetic graph generators (twin of ``repro.graphs.generators``):
the same numpy draws from the same seed, so the same graphs."""
from __future__ import annotations

import numpy as np

from .csr import CSRGraph, from_edge_list


def erdos_renyi(n: int, avg_deg: float, seed: int = 0, *,
                device="cuda") -> CSRGraph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    keep = src != dst
    return from_edge_list(src[keep], dst[keep], n, seed=seed, device=device)


def preferential_attachment(n: int, out_deg: int, seed: int = 0, *,
                            device="cuda") -> CSRGraph:
    """BA-like: each new vertex attaches ``out_deg`` edges preferentially."""
    rng = np.random.default_rng(seed)
    src_list = [0]
    dst_list = [1]
    targets = [0, 1]
    for v in range(2, n):
        picks = rng.choice(len(targets), size=min(out_deg, len(targets)),
                           replace=False)
        for t in picks:
            src_list.append(v)
            dst_list.append(targets[t])
            targets.append(targets[t])
        targets.append(v)
    return from_edge_list(np.array(src_list), np.array(dst_list), n,
                          seed=seed, device=device)


def rmat(n_log2: int, nnz: int, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0, *, device="cuda") -> CSRGraph:
    """RMAT/Kronecker generator (Graph500-style skewed degrees)."""
    rng = np.random.default_rng(seed)
    n = 1 << n_log2
    src = np.zeros(nnz, dtype=np.int64)
    dst = np.zeros(nnz, dtype=np.int64)
    for bit in range(n_log2):
        r = rng.random(nnz)
        go_right = r > (a + b)          # bottom half for src
        r2 = rng.random(nnz)
        top = np.where(go_right, c / max(c + (1 - a - b - c), 1e-9),
                       a / max(a + b, 1e-9))
        go_down = r2 > top              # right half for dst
        src |= go_right.astype(np.int64) << bit
        dst |= go_down.astype(np.int64) << bit
    keep = src != dst
    return from_edge_list(src[keep], dst[keep], n, seed=seed, device=device)


def star(n: int, seed: int = 0, *, device="cuda") -> CSRGraph:
    """Hub 0 points at everyone — a known-OPT fixture for quality tests."""
    src = np.zeros(n - 1, dtype=np.int64)
    dst = np.arange(1, n, dtype=np.int64)
    probs = np.ones(n - 1, dtype=np.float32)  # deterministic activation
    return from_edge_list(src, dst, n, probs=probs, seed=seed, device=device)
