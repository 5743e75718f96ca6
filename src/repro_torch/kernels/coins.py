"""The IC coin plane of one BFS step (``csrc/coin_pack.cu``) and its
plain PyTorch version.

Bit ``b`` of ``plane[v, c * chunk + j, w]`` is set iff bit ``b`` of
``frontier[v, w]`` is set and

    keys[c].uniform((batch, n, chunk))[32 * w + b, v, j] < prob_p[v, c * chunk + j]

— the reference's per-step coin draw (``repro/core/rrr.py:309-325`` and
``_pack_batch_lane``) restricted to the words the expansion reads: it
ANDs each plane word with the frontier word of the same vertex, so the
expansion's result is unchanged.  No TPU kernel stands behind this one
(the reference draws in XLA); the draw has to be a kernel here because
plain threefry over every (sample, vertex, slot) is ~10^11 hashes a step
at real sizes.  Bound: the plane write on sparse frontiers, the hashes
on dense ones.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitset
from repro_torch.core.prng import Key
from repro_torch.kernels import ops

_ARGS = [ops.PTR] * 4 + [ops.I64] * 4


def key_words(keys: list[Key], device) -> torch.Tensor:
    """The chunk keys as the kernels take them: int32 [n_chunks, 2] on
    the card, copied from pinned memory on the current stream, so the
    copy does not wait for the work queued before it."""
    host = bitset.to_words(torch.tensor(
        [[k.k0, k.k1] for k in keys], dtype=torch.int64))
    return host.pin_memory().to(device, non_blocking=True)


def coin_plane_plain(keys: list[Key], prob_p: torch.Tensor,
                     frontier: torch.Tensor, chunk: int) -> torch.Tensor:
    """Hashes only the set frontier bits, through ``prng.Key.uniform_at``."""
    n, d_pad = prob_p.shape
    w_total = frontier.shape[1]
    dev = frontier.device
    plane = torch.zeros((n, d_pad, w_total), dtype=torch.int32, device=dev)
    v, w = torch.nonzero(frontier, as_tuple=True)
    if v.numel() == 0:
        return plane
    lanes = torch.arange(bitset.WORD_BITS, device=dev)
    live = bitset.unpack_words(frontier[v, w][:, None], bitset.WORD_BITS)
    b = bitset.WORD_BITS * w[:, None] + lanes                 # [P, 32]
    j = torch.arange(chunk, device=dev)
    for c, key in enumerate(keys):
        flat = (b[:, None, :] * n + v[:, None, None]) * chunk \
            + j[None, :, None]                                # [P, chunk, 32]
        p = prob_p[v, c * chunk:(c + 1) * chunk]              # [P, chunk]
        fire = (key.uniform_at(flat) < p[:, :, None]) & live[:, None, :]
        plane[v[:, None], (c * chunk + j)[None, :], w[:, None]] = \
            bitset.pack_bits(fire)
    return plane


def coin_plane(keys: list[Key], prob_p: torch.Tensor,
               frontier: torch.Tensor, chunk: int) -> torch.Tensor:
    """prob_p float32 [n, d_pad] (zero at padded slots), frontier int32
    [n, W], one key per chunk of ``chunk`` slots -> plane int32
    [n, d_pad, W]."""
    if not ops.on_card(prob_p, frontier):
        return coin_plane_plain(keys, prob_p, frontier, chunk)
    n, d_pad = prob_p.shape
    w = frontier.shape[1]
    if len(keys) * chunk != d_pad:
        raise ValueError(f"{len(keys)} chunk keys x {chunk} slots != "
                         f"d_pad {d_pad}")
    ops.check(prob_p, "prob_p", torch.float32, (n, d_pad))
    ops.check(frontier, "frontier", torch.int32, (n, w))
    kw = key_words(keys, frontier.device)
    plane = torch.empty((n, d_pad, w), dtype=torch.int32,
                        device=frontier.device)
    if plane.numel() == 0:
        return plane
    ops.launch("coin_pack", "coin_pack", "coin_pack", _ARGS,
               kw.data_ptr(), prob_p.data_ptr(), frontier.data_ptr(),
               plane.data_ptr(), n, d_pad, chunk, w)
    return plane
