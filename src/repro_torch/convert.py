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
    numpy arrays).  The two layouts share every path and shape, so this
    is a plain map once the tree's top level is checked against
    ``cfg``: a decoder-only tree has ``stack{i}/slot{j}/...`` with the
    leading [count] axis, one stack an entry of the plan, and an ``mtp``
    subtree exactly when ``cfg.mtp_depth`` (its ``layer`` unstacked:
    ``ln1`` is [d_model]); the encoder-decoder's has ``encoder`` and
    ``decoder`` stacks, ``enc_norm``, ``dec_norm`` and ``head``.  Raises
    on a tree that does not match."""
    from repro_torch.models.transformer import build_plan
    if cfg.is_encoder_decoder:
        want = {"embed", "head", "enc_norm", "dec_norm", "encoder",
                "decoder"}
        if set(tree) != want:
            raise ValueError(f"{sorted(tree)} is not the encoder-decoder "
                             f"tree of {cfg.name} ({sorted(want)})")
    else:
        want = {f"stack{i}" for i in range(len(build_plan(cfg)))}
        got = {k for k in tree if k.startswith("stack")}
        if got != want:
            raise ValueError(f"stacks {sorted(got)} do not match the plan "
                             f"of {cfg.name} ({sorted(want)})")
        if ("mtp" in tree) != bool(cfg.mtp_depth):
            raise ValueError(f"{cfg.name}: mtp_depth {cfg.mtp_depth}, "
                             f"the tree {'has' if 'mtp' in tree else 'lacks'}"
                             " an mtp subtree")
        if "mtp" in tree and np.shape(tree["mtp"]["layer"]["ln1"]) != (
                cfg.d_model,):
            raise ValueError("the mtp layer must be unstacked: ln1 is "
                             f"{np.shape(tree['mtp']['layer']['ln1'])}")
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return tensor_from_reference(t, device=dev)
    return conv(tree)


def caches_from_reference(caches, *, device="cuda"):
    """The port's caches from the reference's (``KVCache``,
    ``RGLRUCache``, ``SSMCache`` records of numpy arrays, in the lists
    and dicts the model's ``init_caches`` builds)."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.rglru import RGLRUCache
    from repro_torch.models.ssm import SSMCache
    records = {c.__name__: c for c in (KVCache, RGLRUCache, SSMCache)}
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)) and not hasattr(t, "_fields"):
            return type(t)(conv(v) for v in t)
        if hasattr(t, "_fields"):
            return records[type(t).__name__](*(conv(v) for v in t))
        return tensor_from_reference(t, device=dev)
    return conv(caches)


def batch_from_reference(batch, *, device="cuda"):
    """A batch dict (``tokens``, ``patches``, ``frames``) from numpy
    arrays."""
    return {k: tensor_from_reference(v, device=device)
            for k, v in batch.items()}
