"""Deterministic synthetic token pipeline + GreediRIS coreset selection
— twin of ``repro.data.pipeline``.

The pipeline is keyed by (seed, step): any worker can recompute any
batch.  The draws go through the port's threefry (``core.prng``), so a
batch holds the reference's tokens: ``jax.random.categorical`` is the
argmax over the vocabulary of ``log p + gumbel``, with gumbel
``-log(-log(u))`` and ``u`` uniform on ``[tiny, 1)`` over [B, S, V]
(jax's "low" mode).  A token can differ from the reference's only where
two candidates' scores lie within the float32 ``log``'s last-place
rounding, which the two libraries round differently.  The gumbel plane
is drawn one batch row at a time.

``CoresetSelector`` is the paper's technique at the data layer: each
candidate document is a covering set over hashed n-gram buckets, and the
k documents that maximize coverage are picked with the streaming
max-k-cover (or the greedy one).  On CUDA tensors the stream goes
through the fused receiver (``bucket_insert_stream``) and the greedy
picks through the resident solver (``greedy_pick``); on the CPU both
take their plain versions.  Every route gives the reference's ids and
coverage.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import bitset, maxcover, prng, resolve_device, streaming

_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic corpus statistics: zipfian unigram + markov repetition
    zipf_a: float = 1.2
    repeat_p: float = 0.3


class TokenPipeline:
    """Stateless batch generator: batch(step) is pure in (cfg, step)."""

    def __init__(self, cfg: DataConfig, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        probs = 1.0 / np.arange(1, cfg.vocab_size + 1) ** cfg.zipf_a
        p32 = torch.from_numpy((probs / probs.sum()).astype(np.float32))
        self._logp = torch.log(p32.to(self.device))

    def batch(self, step: int, extra_token: bool = True) -> torch.Tensor:
        """int32 [global_batch, seq_len (+1)] tokens of ``step``."""
        c = self.cfg
        key = prng.key(c.seed).fold_in(step)
        s = c.seq_len + (1 if extra_token else 0)
        k1, k2, _ = key.split(3)
        v = c.vocab_size
        shape = (c.global_batch, s, v)
        base = torch.empty((c.global_batch, s), dtype=torch.int64,
                           device=self.device)
        for b in range(c.global_batch):
            u = k1.uniform_slice(shape, b * s * v, (b + 1) * s * v,
                                 device=self.device).reshape(s, v)
            gumbel = -torch.log(-torch.log(u.clamp_min(_TINY)))
            base[b] = torch.argmax(gumbel + self._logp, dim=-1)
        # markov repetition: with prob repeat_p, copy the previous token
        rep = k2.uniform((c.global_batch, s), device=self.device) < c.repeat_p
        shifted = torch.nn.functional.pad(base[:, :-1], (1, 0))
        return torch.where(rep, shifted, base).to(torch.int32)

    def __iter__(self) -> Iterator[torch.Tensor]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class CoresetSelector:
    """Streaming max-k-cover document selection (GreediRIS at the data
    layer).  Documents hash into `universe` n-gram buckets; coverage of
    a training subset == diversity of its token patterns."""

    def __init__(self, universe: int = 4096, ngram: int = 2,
                 delta: float = 0.077, *, device="cuda"):
        assert universe % 32 == 0
        self.universe = universe
        self.ngram = ngram
        self.delta = delta
        self.device = resolve_device(device)

    def doc_signature(self, tokens: np.ndarray) -> np.ndarray:
        """Hash the doc's n-grams into a packed coverage row: uint32 [W]."""
        t = np.asarray(tokens, dtype=np.uint64)
        h = t[: len(t) - self.ngram + 1].copy()
        for j in range(1, self.ngram):
            h = h * np.uint64(1000003) + t[j: len(t) - self.ngram + 1 + j]
        idx = (h % np.uint64(self.universe)).astype(np.int64)
        return bitset.pack_indices(idx, self.universe).numpy().view(
            np.uint32)

    def select(self, docs: np.ndarray, k: int, use_streaming: bool = True):
        """docs [N, S] int tokens -> (selected indices [<=k], coverage)."""
        sig = np.stack([self.doc_signature(d) for d in docs])
        rows = torch.from_numpy(sig.view(np.int32)).to(self.device)
        if not use_streaming:
            sol = maxcover.greedy_maxcover(rows, k, solver="resident")
            return sol.seeds.cpu().numpy(), int(sol.coverage)
        # order by a cheap richness proxy (unique tokens) to help the
        # one-pass streaming thresholds, then stream
        order = np.argsort([-len(np.unique(d)) for d in docs])
        lower = float(np.float32(bitset.popcount(rows).sum(-1).max().item()))
        ids = torch.from_numpy(order.astype(np.int32)).to(self.device)
        seeds, cov, _ = streaming.streaming_maxcover(
            ids, rows[torch.from_numpy(order).to(self.device)], k,
            self.delta, lower, receiver="pipelined")
        sel = seeds.cpu().numpy()
        return sel[sel >= 0], int(cov)
