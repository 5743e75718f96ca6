"""A frozen copy of the threefry-2x32 draws the configurations state.

Every random choice of a run (roots, coins, LT draws, the RandGreedi
partition) is element ``i`` of a threefry-2x32 draw in partitionable
mode: the 32 bits of element ``i`` are ``x0 ^ x1`` of the block of
counter ``(i >> 32, i & 0xFFFFFFFF)``; ``fold_in(d)`` is the block of
counter ``(0, d)`` and ``split()[i]`` the block of counter ``(0, i)``.
Values are uint32 held in int64 tensors or Python ints.
"""
from __future__ import annotations

import dataclasses
import math

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def block(k0, k1, x0, x1):
    """The 20-round threefry-2x32 block of counter (x0, x1) under key
    (k0, k1)."""
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


def to_float(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1): the top 23 bits as a mantissa in [1, 2), less 1."""
    return (((bits >> 9) | 0x3F800000).to(torch.int32)
            .view(torch.float32) - 1.0)


@dataclasses.dataclass(frozen=True)
class Key:
    k0: int
    k1: int

    @classmethod
    def from_seed(cls, seed: int) -> "Key":
        """The run's key: the seed's high and low 32 bits."""
        seed = int(seed)
        if seed < 0 or seed >> 64:
            raise ValueError(f"seed must lie in [0, 2**64), got {seed}")
        return cls((seed >> 32) & M32, seed & M32)

    def fold_in(self, data: int) -> "Key":
        return Key(*block(self.k0, self.k1, 0, int(data) & M32))

    def split(self, num: int = 2) -> list["Key"]:
        return [Key(*block(self.k0, self.k1, 0, i)) for i in range(num)]

    def bits_at(self, index: torch.Tensor) -> torch.Tensor:
        index = index.to(torch.int64)
        y0, y1 = block(self.k0, self.k1, index >> 32, index & M32)
        return y0 ^ y1

    def uniform_at(self, index: torch.Tensor) -> torch.Tensor:
        return to_float(self.bits_at(index))

    def randint_at(self, index: torch.Tensor, span: int) -> torch.Tensor:
        """Elements ``index`` of a draw of integers in [0, span): two
        32-bit draws combined modulo the span, wrapping at 2**32."""
        k_hi, k_lo = self.split()
        hi, lo = k_hi.bits_at(index), k_lo.bits_at(index)
        mult = (((65536 % span) ** 2) & M32) % span
        off = ((((hi % span) * mult) & M32) + (lo % span)) & M32
        return off % span

    def permutation(self, n: int, *, device) -> torch.Tensor:
        """A uniform permutation of range(n): stable sorts of the current
        order by fresh 32-bit draws, ceil(3 ln n / ln(2**32 - 1)) times."""
        rounds = math.ceil(3 * math.log(max(1, n)) / math.log(M32))
        x = torch.arange(n, dtype=torch.int64, device=device)
        idx = torch.arange(n, dtype=torch.int64, device=device)
        key = self
        for _ in range(rounds):
            key, sub = key.split()
            x = x[torch.sort(sub.bits_at(idx), stable=True).indices]
        return x
