"""Compressed-sparse-row graph container (twin of ``repro.graphs.csr``).

The graphs are built in numpy on the host, exactly as the reference
builds them from the same seed, and then placed on the requested
device; the padded reverse table is scattered on that device.  The container stores CSR over *incoming* edges:
``indptr[v] .. indptr[v+1]`` indexes the in-neighbors of ``v``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import resolve_device, span


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Reverse-CSR graph with per-edge probabilities.

    Attributes:
      indptr:  int32 [n + 1]    row pointers (rows = destination vertices)
      indices: int32 [nnz]      in-neighbor (source) vertex of each edge
      probs:   float32 [nnz]    IC activation probability of each edge
      weights: float32 [nnz]    LT edge weight (incoming sums <= 1)
    """
    indptr: torch.Tensor
    indices: torch.Tensor
    probs: torch.Tensor
    weights: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @property
    def num_vertices(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def max_in_degree(self) -> int:
        deg = torch.diff(self.indptr)
        return int(deg.max()) if deg.numel() else 0


def from_arrays(indptr, indices, probs, weights, *, device) -> CSRGraph:
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a).astype(dtype), device=dev)
    return CSRGraph(indptr=put(indptr, np.int32),
                    indices=put(indices, np.int32),
                    probs=put(probs, np.float32),
                    weights=put(weights, np.float32))


def from_edge_list(src: np.ndarray, dst: np.ndarray, n: int,
                   probs: Optional[np.ndarray] = None,
                   seed: int = 0, *, device="cuda") -> CSRGraph:
    """Build the reverse-CSR graph from a directed edge list src -> dst."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    nnz = src.shape[0]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr)
    rng = np.random.default_rng(seed)
    if probs is None:
        # Paper §4.1: uniform random edge probabilities in [0, 0.1].
        probs = rng.uniform(0.0, 0.1, size=nnz).astype(np.float32)
    else:
        probs = np.asarray(probs, dtype=np.float32)[order]
    # LT weights: random, then normalized so each vertex's incoming sum <= 1.
    raw = rng.uniform(0.1, 1.0, size=nnz).astype(np.float64)
    in_deg = np.diff(indptr)
    row_of_edge = np.repeat(np.arange(n), in_deg)
    row_sum = np.zeros(n, dtype=np.float64)
    np.add.at(row_sum, row_of_edge, raw)
    denom = np.maximum(row_sum[row_of_edge], 1e-12)
    weights = (raw / denom).astype(np.float32)
    return from_arrays(indptr, src, probs, weights, device=device)


def to_dense_prob(g: CSRGraph) -> np.ndarray:
    """Dense [n, n] IC probability matrix P[v, u] = p(u -> v), as numpy
    on the host (a later duplicate edge overwrites an earlier one, as
    the reference's loop does).  Test helper."""
    n = g.num_vertices
    indptr, src = _host(g)
    dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dense = np.zeros((n, n), dtype=np.float32)
    dense[dst, src] = g.probs.cpu().numpy()
    return dense


def _host(g: CSRGraph):
    return (g.indptr.cpu().numpy().astype(np.int64),
            g.indices.cpu().numpy().astype(np.int64))


def padded_forward_adjacency(g: CSRGraph, pad_to: Optional[int] = None,
                             rev_pad_to: Optional[int] = None):
    """Padded *forward* adjacency: for each out-edge ``u -> v`` of row
    ``u``, the destination ``v`` and the slot of that edge in ``v``'s
    :func:`padded_adjacency` row (``nbr[v, rev_slot] == u``).

    Returns ``(fwd_nbr, fwd_rslot)`` int32 ``[n, d_out_max]`` on the
    graph's device, padded with ``fwd_nbr = -1`` (``fwd_rslot = 0``).
    The build, in numpy on the host, is the span ``tables.forward``, and
    its copies to the device ``tables.forward.copy`` within it.
    """
    with span("tables.forward"):
        n = g.num_vertices
        indptr, src = _host(g)
        in_deg = np.diff(indptr)
        rev_v = np.repeat(np.arange(n, dtype=np.int64), in_deg)
        rev_slot = np.arange(src.shape[0], dtype=np.int64) - np.repeat(
            indptr[:-1], in_deg)
        if rev_pad_to is not None:
            keep = rev_slot < int(rev_pad_to)
            src, rev_v, rev_slot = src[keep], rev_v[keep], rev_slot[keep]
        order = np.argsort(src, kind="stable")
        src, rev_v, rev_slot = src[order], rev_v[order], rev_slot[order]
        out_deg = (np.bincount(src, minlength=n) if src.size
                   else np.zeros(n, dtype=np.int64))
        df = int(pad_to if pad_to is not None
                 else (out_deg.max() if src.size else 0))
        fwd_nbr = np.full((n, df), -1, dtype=np.int32)
        fwd_rslot = np.zeros((n, df), dtype=np.int32)
        fptr = np.zeros(n + 1, dtype=np.int64)
        fptr[1:] = np.cumsum(out_deg)
        pos = np.arange(src.shape[0], dtype=np.int64) - fptr[src]
        ok = pos < df
        fwd_nbr[src[ok], pos[ok]] = rev_v[ok]
        fwd_rslot[src[ok], pos[ok]] = rev_slot[ok]
        with span("tables.forward.copy"):
            return (torch.from_numpy(fwd_nbr).to(g.device),
                    torch.from_numpy(fwd_rslot).to(g.device))


def padded_adjacency(g: CSRGraph, pad_to: Optional[int] = None):
    """Padded [n, d_max] in-neighbor / prob / weight tables: row v lists
    the in-neighbors of v, padded with -1 (prob/weight 0).  The
    reference fills rows in a per-vertex loop; this scatters every edge
    to its (row, slot) at once, on the graph's device (one host read:
    d_max), with identical output.  The build is the span
    ``tables.reverse``; the scatters it starts may run past its end."""
    with span("tables.reverse"):
        n = g.num_vertices
        dev = g.device
        indptr = g.indptr.long()
        deg = indptr[1:] - indptr[:-1]
        d = int(pad_to if pad_to is not None else (deg.max() if n else 0))
        nbr = torch.full((n, d), -1, dtype=torch.int32, device=dev)
        prob = torch.zeros((n, d), dtype=torch.float32, device=dev)
        wt = torch.zeros((n, d), dtype=torch.float32, device=dev)
        e = g.num_edges
        if n == 0 or d == 0 or e == 0:
            return nbr, prob, wt
        row = torch.repeat_interleave(torch.arange(n, device=dev), deg,
                                      output_size=e)
        slot = torch.arange(e, device=dev) - indptr[row]
        flat = row * d + slot
        if pad_to is not None:
            ok = slot < d
            flat, keep = flat[ok], ok
        else:
            keep = slice(None)
        nbr.view(-1)[flat] = g.indices[keep]
        prob.view(-1)[flat] = g.probs[keep]
        wt.view(-1)[flat] = g.weights[keep]
        return nbr, prob, wt
