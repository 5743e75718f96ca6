"""Monte-Carlo influence estimation — the ``influence(g, seeds, key)``
entry point of ``repro.core.diffusion``, over :mod:`repro_torch.core.cascade`.
"""
from __future__ import annotations

import torch

from repro_torch.core import cascade
from repro_torch.core.prng import Key
from repro_torch.graphs.csr import CSRGraph


def influence(g: CSRGraph, seeds, key: Key, model: str = "IC",
              num_sims: int = 64, max_steps: int = 64,
              engine: str = "kernel", coin_chunk: int = 32) -> torch.Tensor:
    """Monte-Carlo estimate of sigma(seeds); -1 pads are ignored."""
    return cascade.spread(g, seeds, key, model=model, num_sims=num_sims,
                          max_steps=max_steps, engine=engine,
                          coin_chunk=coin_chunk)
