"""Threefry-2x32 twin of ``jax.random`` in partitionable mode.

Every draw on the reference's main path goes through ``jax.random``
with threefry2x32 and ``jax_threefry_partitionable=True``.  In that
mode the 32 random bits of element ``i`` of a draw depend only on the
key and the 64-bit flat index ``i``: the counter pair is
``(i >> 32, i & 0xFFFFFFFF)`` and the bits are ``x0 ^ x1`` of the
threefry block.  Keys derive the same way: ``fold_in(key, d)`` is the
block of counter ``(0, d)`` and ``split(key, n)[i]`` the block of
counter ``(0, i)``.  So this module reproduces every draw bit for bit,
and can draw any slice of a draw (``uniform_at``) without building the
rest — which is what the coin kernel does on the card.

Values are uint32 held in int64 tensors (or Python ints for key
arithmetic); the same ``threefry2x32`` body serves both.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry-2x32 block (20 rounds) of counter ``(x0, x1)`` under
    key ``(k0, k1)``.  Works on Python ints and on int64 tensors holding
    uint32 values; returns the pair ``(y0, y1)`` in the same form."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def float_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from 32 random bits: ``(bits >> 9) | 0x3f800000``
    reinterpreted as float, minus 1 (``jax.random.uniform``'s mapping)."""
    return (((bits >> 9) | 0x3F800000).to(torch.int32)
            .view(torch.float32) - 1.0)


@dataclasses.dataclass(frozen=True)
class Key:
    """A threefry key: the two uint32 words of ``jax.random.key_data``."""
    k0: int
    k1: int

    def block(self, hi, lo):
        return threefry2x32(self.k0, self.k1, hi, lo)

    def fold_in(self, data: int) -> "Key":
        return Key(*self.block(0, int(data) & M32))

    def split(self, num: int = 2) -> list["Key"]:
        return [Key(*self.block(0, i)) for i in range(num)]

    def bits_at(self, index: torch.Tensor) -> torch.Tensor:
        """Random bits (uint32 in int64) at the given flat indices of a
        draw of any shape: element ``i`` of ``random_bits(key, shape)``."""
        index = index.to(torch.int64)
        y0, y1 = self.block(index >> 32, index & M32)
        return y0 ^ y1

    def uniform_at(self, index: torch.Tensor) -> torch.Tensor:
        """float32 uniforms at the given flat indices of a draw."""
        return float_from_bits(self.bits_at(index))

    def uniform(self, shape, *, device) -> torch.Tensor:
        n = math.prod(shape)
        idx = torch.arange(n, dtype=torch.int64, device=device)
        return self.uniform_at(idx).reshape(shape)

    def uniform_slice(self, shape, start: int, stop: int, *,
                      device) -> torch.Tensor:
        """Flat elements ``[start, stop)`` of ``uniform(shape)``."""
        if not 0 <= start <= stop <= math.prod(shape):
            raise ValueError(f"slice [{start}, {stop}) outside {shape}")
        idx = torch.arange(start, stop, dtype=torch.int64, device=device)
        return self.uniform_at(idx)

    def randint(self, shape, minval: int, maxval: int, *,
                device) -> torch.Tensor:
        """int32 ``jax.random.randint``: two 32-bit draws combined modulo
        the span, with the reference's uint32 wrap-around."""
        if not (-2**31 <= minval < 2**31 and -2**31 <= maxval < 2**31):
            raise ValueError("randint bounds must fit in int32")
        k_hi, k_lo = self.split()
        n = math.prod(shape)
        idx = torch.arange(n, dtype=torch.int64, device=device)
        hi, lo = k_hi.bits_at(idx), k_lo.bits_at(idx)
        span = 1 if maxval <= minval else (maxval - minval) & M32
        mult = (((65536 % span) ** 2) & M32) % span
        off = ((((hi % span) * mult) & M32) + (lo % span)) & M32
        return (minval + off % span).to(torch.int32).reshape(shape)

    def permutation(self, n: int, *, device) -> torch.Tensor:
        """int32 ``jax.random.permutation(key, n)``: stable sorts of
        ``arange(n)`` by fresh 32-bit keys, as ``random._shuffle``."""
        rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
        x = torch.arange(n, dtype=torch.int32, device=device)
        key = self
        idx = torch.arange(n, dtype=torch.int64, device=device)
        for _ in range(rounds):
            key, sub = key.split()
            order = torch.sort(sub.bits_at(idx), stable=True).indices
            x = x[order]
        return x


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a seed in [0, 2**31) (the reference
    runs with 32-bit integers, so its key is the pair ``(0, seed)``)."""
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed must lie in [0, 2**31), got {seed}")
    return Key(0, seed)


def key_from_data(data) -> Key:
    """A key from its two uint32 words (``jax.random.key_data``)."""
    d = np.asarray(data).astype(np.uint64).reshape(-1)
    if d.shape != (2,):
        raise ValueError(f"key data must hold 2 words, got {d.shape}")
    return Key(int(d[0]) & M32, int(d[1]) & M32)
