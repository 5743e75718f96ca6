"""Carry the reference's data across to the port (numpy in, torch out).

Used by the parity tests, which run both packages in one process and
pass data between them only as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng, resolve_device
from repro_torch.graphs.csr import CSRGraph, from_arrays


def graph_from_reference(indptr, indices, probs, weights, *,
                         device="cuda") -> CSRGraph:
    """A port graph from the numpy arrays of a ``repro`` ``CSRGraph``."""
    return from_arrays(indptr, indices, probs, weights, device=device)


def key_from_reference(key_data) -> prng.Key:
    """A port key from ``np.asarray(jax.random.key_data(k))``."""
    return prng.key_from_data(key_data)


def words_from_reference(u32, *, device="cuda") -> torch.Tensor:
    """uint32 words viewed as the port's int32 bit patterns."""
    arr = np.ascontiguousarray(np.asarray(u32, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(resolve_device(device))
