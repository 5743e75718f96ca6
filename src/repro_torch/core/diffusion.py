"""Monte-Carlo influence estimation — the ``influence(g, seeds, key)``
entry point of ``repro.core.diffusion``, over :mod:`repro_torch.core.cascade`,
and the threshold form of LT (``lt_threshold_influence``), kept as the
cross-check of the live-edge form the cascade engines run.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import cascade
from repro_torch.core.prng import Key
from repro_torch.graphs.csr import CSRGraph, padded_adjacency


def influence(g: CSRGraph, seeds, key: Key, model: str = "IC",
              num_sims: int = 64, max_steps: int = 64,
              engine: str = "kernel", coin_chunk: int = 32) -> torch.Tensor:
    """Monte-Carlo estimate of sigma(seeds); -1 pads are ignored."""
    return cascade.spread(g, seeds, key, model=model, num_sims=num_sims,
                          max_steps=max_steps, engine=engine,
                          coin_chunk=coin_chunk)


def _lt_threshold(rev_nbr, rev_wt, seeds_mask, key: Key, *, num_sims: int,
                  max_steps: int) -> torch.Tensor:
    """Threshold LT, one simulation at a time: simulation i draws vertex
    thresholds ``tau = uniform(split(key, num_sims)[i], (n,))``, and each
    step activates every vertex whose active in-neighbour weight mass
    (float32, summed along the row) reaches its threshold, while the
    last step grew the set and fewer than ``max_steps`` steps ran.
    Returns the float32 mean activation count.  The keys and draws
    are the reference's; the row sums are torch's, whose order may
    differ from XLA's by an ulp and so flip a ``mass >= tau`` tie (the
    parity tests have found none)."""
    n = rev_nbr.shape[0]
    dev = rev_nbr.device
    valid = rev_nbr >= 0
    src = rev_nbr.clamp(min=0).long()
    counts = torch.empty(num_sims, dtype=torch.int32, device=dev)
    for i, k in enumerate(key.split(num_sims)):
        tau = k.uniform((n,), device=dev)
        active, grew, step = seeds_mask, True, 0
        while grew and step < max_steps:
            mass = torch.where(valid & active[src], rev_wt, 0.0).sum(1)
            hit = mass >= tau
            grew = bool((hit & ~active).any())
            active = active | hit
            step += 1
        counts[i] = active.sum()
    # The reference's jitted mean multiplies by the float32 reciprocal
    # of num_sims (XLA's simplifier turns the division into that), which
    # can differ from a division by an ulp.
    inv = torch.tensor(np.float32(1) / np.float32(num_sims), device=dev)
    return counts.to(torch.float32).sum() * inv


def lt_threshold_influence(g: CSRGraph, seeds, key: Key, num_sims: int = 64,
                           max_steps: int = 64) -> torch.Tensor:
    """Threshold-semantics LT Monte Carlo: distributed as
    ``influence(..., model="LT")`` (the live-edge form) but on another
    coin stream.  -1 pads and out-of-range seeds are dropped."""
    rev_nbr, _rev_prob, rev_wt = padded_adjacency(g)
    seeds_mask = cascade.seeds_to_mask(g.num_vertices, seeds,
                                       device=g.device)
    return _lt_threshold(rev_nbr, rev_wt, seeds_mask, key,
                         num_sims=int(num_sims), max_steps=int(max_steps))
