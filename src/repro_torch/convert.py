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


def tensor_from_reference(arr, *, device="cuda") -> torch.Tensor:
    """A tensor from a numpy array of the reference; bfloat16 arrays
    (``ml_dtypes``) keep their bits."""
    arr = np.array(arr)           # a writable copy
    dev = resolve_device(device)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def params_from_reference(tree, cfg, *, device="cuda"):
    """The port's parameter tree from the reference's (nested dicts of
    numpy arrays).  The two layouts share every path and shape
    (``stack{i}/slot{j}/...`` with the leading [count] axis), so this is
    a plain map; raises if the stacks do not match ``cfg``'s plan."""
    from repro_torch.models.transformer import build_plan
    want = {f"stack{i}" for i in range(len(build_plan(cfg)))}
    got = {k for k in tree if k.startswith("stack")}
    if got != want:
        raise ValueError(f"stacks {sorted(got)} do not match the plan of "
                         f"{cfg.name} ({sorted(want)})")
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return tensor_from_reference(t, device=dev)
    return conv(tree)


def batch_from_reference(batch, *, device="cuda"):
    """A batch dict (``tokens``, ``patches``) from numpy arrays."""
    return {k: tensor_from_reference(v, device=device)
            for k, v in batch.items()}
