"""GreediRIS: the fixed-theta distributed streaming round (paper §3.4)
and the Ripples baseline round — twin of ``repro.core.greediris``, with
the m machines as a batch axis on one device instead of a mesh.

What a mesh does becomes tensor algebra on the machine axis:

  S1 sampling   machine p draws theta/m RRR sets from key.fold_in(p)
                (any sampler, ``max_steps=32``); the
                machines sample one after another, and each machine's
                incidence is freed once shuffled.
  S2 shuffle    "dense": the tiled all_to_all — machine j's rows are,
                in source order p = 0..m-1 along the word axis, rows
                j*per:(j+1)*per of each x^(p)[perm] (perm a random
                permutation of the n_pad vertices, pads included).
                "sparse": the COO exchange — (vertex, sample) pairs in
                ``cap`` slots per (source, destination), ranked by a
                cumulative sum, the overflow dropped exactly as the
                reference drops it, then the rows rebuilt by a scatter.
  S3 senders    one greedy_maxcover over [m, per, W_global] with any
                solver; the first round(alpha*k) seeds are sent, and a
                machine not in ``survivors`` sends id -1 and zero rows.
  S4 receiver   "gather": one receiver over the concatenated [m*kk]
                stream (the pipelined stream kernel under use_kernel);
                "pipeline": m receivers, receiver j inserting the ring
                payloads of machines j, j-1, ..., j-m+1, one chunk
                insertion per ring step; the first best receiver wins.
  merge         best receiver against the best local solution.

``build_ripples_round`` is the baseline: samples stay with their
machine, and each of the k picks sums the machines' gain vectors (the
all-reduce GreediRIS removes).  The reference samples it with its
dense sampler; the port takes any sampler, which the reference's
sampler contract makes bit-identical.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import StageClock, bitset, maxcover, randgreedi, rrr
from repro_torch.core import streaming
from repro_torch.kernels import bucket_insert

AGGREGATES = ("gather", "pipeline")
SHUFFLES = ("dense", "sparse")


class GreediRISOut(NamedTuple):
    seeds: torch.Tensor               # int32 [k] global vertex ids (-1 pad)
    coverage: torch.Tensor            # int32 [] coverage of returned seeds
    global_coverage: torch.Tensor     # best streaming-receiver coverage
    best_local_coverage: torch.Tensor


def _local_theta(theta: int, m: int, sample_chunks: int) -> int:
    theta_local = ((theta // m + 31) // 32) * 32
    if sample_chunks < 1 or theta_local % (32 * sample_chunks):
        raise ValueError(
            f"sample_chunks={sample_chunks} must split theta_local="
            f"{theta_local} into whole words")
    return theta_local


def _machine_sampler(*, n: int, theta_local: int, sample_chunks: int,
                     model: str, max_steps: int, sampler, fwd,
                     coin_chunk: int, gather: str, lt=None):
    """sample(nbr, prob, wt, key, p, i) -> the packed words [rows, b/32]
    of machine p's i-th sample chunk (b = theta_local / sample_chunks),
    drawn as the reference's shard body draws them.  The LT push reads
    ``lt`` (``graphs.csr.lt_reverse``), and its callers may pass
    ``nbr = prob = wt = None`` (``rrr.reads_padded``)."""
    sampler = rrr.resolve_sampler(sampler)
    rrr.require_fwd(fwd, sampler, gather, f"sampler={sampler!r}")
    fwd = (None, None) if fwd is None else fwd
    if not isinstance(coin_chunk, int) or coin_chunk < 1:
        raise ValueError(f"coin_chunk must be a positive slot count, got "
                         f"{coin_chunk!r}")
    if gather not in rrr.GATHERS:
        raise ValueError(f"unknown gather {gather!r}; expected {rrr.GATHERS}")
    b = theta_local // sample_chunks
    expand = "kernel" if sampler == "kernel" else "plain"

    def sample(nbr, prob, wt, key, p: int, i: int):
        kr, kb = key.fold_in(p).fold_in(i).split()
        roots = kr.randint((b,), 0, n, device=rrr._device(nbr, lt))
        if sampler == "dense":
            return bitset.pack_bool_matrix(rrr.rrr_batch(
                nbr, prob, wt, roots, kb, model=model, max_steps=max_steps,
                coin_chunk=coin_chunk).T)
        return rrr.rrr_batch_packed(
            nbr, prob, wt, fwd[0], fwd[1], roots, kb, model=model,
            max_steps=max_steps, coin_chunk=coin_chunk, expand=expand,
            gather=gather, lt=lt)
    return sample


def build_round(*, m: int, n: int, theta: int, k: int, max_degree: int,
                model: str = "IC", delta: float = 0.077,
                alpha_trunc: float = 1.0, aggregate: str = "gather",
                max_steps: int = 32, sample_chunks: int = 1,
                use_kernel: bool = False, shuffle: str = "dense",
                est_rrr_len: float = 16.0,
                chunk_size: int | str | None = None,
                solver: str | None = None, sampler: str | None = None,
                fwd=None, coin_chunk: int = 32, gather: str = "auto",
                survivors=None, lt=None):
    """The distributed round over m machines on one device: returns
    ``(fn, n_pad, theta)`` where ``fn(nbr, prob, wt, key, stats=None)``
    -> :class:`GreediRISOut` runs on the graph tables' device;
    ``fn.sample_shuffle(nbr, prob, wt, key)`` runs S1 and S2 alone.
    The LT push samples from ``lt`` (``rrr.graph_tables``), and ``fn``
    then takes ``nbr = prob = wt = None``.

    The reference's arguments, less ``mesh`` and ``axes`` (``m`` is the
    machine count) and ``block_v`` (the port's kernels fix their tiles).
    ``max_degree`` is accepted and unused, as
    in the reference.  ``solver`` None means "fused" with ``use_kernel``
    and "scan" without; ``use_kernel`` also routes the receiver through
    its kernels.  ``chunk_size`` (int, None or "auto") chunks the
    gather receiver; "auto", or None with ``use_kernel``, is the stream
    kernel's capacity (``bucket_insert.auto_chunk_size``).  No result
    depends on the solver, the receiver path, the sampler path or the
    chunk size.  ``stats`` gathers the stage seconds ``sample_shuffle_s``,
    ``senders_s``, ``receiver_s`` and ``merge_s``, the card synchronized
    at each stage's ends, and under the sparse shuffle the count of
    pairs its capacity dropped (``shuffle_dropped_pairs``).
    """
    if isinstance(chunk_size, str) and chunk_size != "auto":
        raise ValueError(f"chunk_size must be an int, None, or 'auto', "
                         f"got {chunk_size!r}")
    if isinstance(chunk_size, int) and chunk_size <= 0:
        raise ValueError(f"chunk_size must be a positive candidate count, "
                         f"None (whole stream), or 'auto', got {chunk_size}")
    if aggregate not in AGGREGATES:
        raise ValueError(f"unknown aggregate {aggregate!r}; expected "
                         f"{AGGREGATES}")
    if shuffle not in SHUFFLES:
        raise ValueError(f"unknown shuffle {shuffle!r}; expected {SHUFFLES}")
    if solver is None:
        solver = "fused" if use_kernel else "scan"
    solver = maxcover.resolve_solver(solver)
    survivors = randgreedi.normalize_survivors(survivors, m)
    n_pad = ((n + m - 1) // m) * m
    per = n_pad // m
    theta_local = _local_theta(theta, m, sample_chunks)
    w_local = theta_local // 32
    w_global = w_local * m
    kk = max(1, int(round(alpha_trunc * k)))
    auto_chunk = chunk_size == "auto" or (
        chunk_size is None and use_kernel and aggregate == "gather")
    cap = max(64, int(2.0 * theta_local * est_rrr_len / m))
    b = theta_local // sample_chunks
    sample = _machine_sampler(
        n=n, theta_local=theta_local, sample_chunks=sample_chunks,
        model=model, max_steps=max_steps, sampler=sampler, fwd=fwd,
        coin_chunk=coin_chunk, gather=gather, lt=lt)

    def dense_shuffle(nbr, prob, wt, key, perm):
        dev = rrr._device(nbr, lt)
        x_s = torch.empty((m, per, w_global), dtype=torch.int32, device=dev)
        for p in range(m):
            x_p = torch.zeros((n_pad, w_local), dtype=torch.int32,
                              device=dev)
            for i in range(sample_chunks):
                x_p[:n, i * b // 32:(i + 1) * b // 32] = sample(
                    nbr, prob, wt, key, p, i)
            x_s[:, :, p * w_local:(p + 1) * w_local] = x_p[perm].reshape(
                m, per, w_local)
            del x_p
        return x_s

    def sparse_shuffle(nbr, prob, wt, key, perm, stats):
        dev = rrr._device(nbr, lt)
        inv_perm = torch.argsort(perm)
        send = torch.zeros((m, m, cap, 2), dtype=torch.int32, device=dev)
        send[..., 1] = -1                      # empty slot: sample id -1
        size = cap * m // sample_chunks
        dropped = torch.zeros((), dtype=torch.int64, device=dev)
        for p in range(m):
            counts = torch.zeros((m,), dtype=torch.int64, device=dev)
            for i in range(sample_chunks):
                s_idx, v_idx = bitset.packed_nonzero(
                    sample(nbr, prob, wt, key, p, i), size=size)
                valid = s_idx >= 0
                gid = p * theta_local + i * b + s_idx
                pos = inv_perm[v_idx.clamp(min=0).long()].long()
                dst = torch.where(valid, pos // per, m)       # m = discard
                onehot = torch.nn.functional.one_hot(dst, m + 1)[:, :m]
                dcl = dst.clamp(max=m - 1)
                rank = onehot.cumsum(0).gather(1, dcl[:, None])[:, 0] - 1
                slot = counts[dcl] + rank
                ok = valid & (slot < cap)
                send[p, dst[ok], slot[ok], 0] = (pos % per)[ok].to(torch.int32)
                send[p, dst[ok], slot[ok], 1] = gid[ok]
                counts += (onehot * ok[:, None]).sum(0)
                dropped += (valid & ~ok).sum()
        if stats is not None:
            stats["shuffle_dropped_pairs"] = int(dropped)
        # the all_to_all: destination j receives every source's slots
        recv = send.transpose(0, 1).reshape(m, m * cap, 2)
        v_l, s_g = recv[..., 0].long(), recv[..., 1].long()
        ok = s_g >= 0
        j = torch.arange(m, device=dev)[:, None].expand_as(v_l)
        flat = ((j * per + v_l) * w_global + s_g // 32)[ok]
        x_s = torch.zeros(m * per * w_global, dtype=torch.int32, device=dev)
        # each (vertex, sample) pair is one distinct bit: add == OR
        x_s.index_put_((flat,), bitset.to_words(1 << (s_g[ok] % 32)),
                       accumulate=True)
        return x_s.reshape(m, per, w_global)

    def sample_shuffle(nbr, prob, wt, key, stats=None):
        """S1 + S2: (the machines' shuffled rows int32 [m, per, W_global],
        the vertex permutation int64 [n_pad])."""
        perm = key.fold_in(0x9E37).permutation(
            n_pad, device=rrr._device(nbr, lt)).long()
        if shuffle == "dense":
            return dense_shuffle(nbr, prob, wt, key, perm), perm
        return sparse_shuffle(nbr, prob, wt, key, perm, stats), perm

    def fn(nbr, prob, wt, key, stats=None) -> GreediRISOut:
        dev = rrr._device(nbr, lt)
        with StageClock(stats, "sample_shuffle_s", dev):
            x_s, perm = sample_shuffle(nbr, prob, wt, key, stats)
        with StageClock(stats, "senders_s", dev):
            sol = maxcover.greedy_maxcover(x_s, k, solver=solver)
            del x_s
            local_ids = torch.where(
                sol.seeds >= 0,
                perm.reshape(m, per).gather(1, sol.seeds.clamp(min=0).long()),
                -1).to(torch.int32)                              # [m, k]
            local_cov = sol.coverage                             # [m]
            gain0 = sol.gains[:, 0].to(torch.float32)
            sent_rows = sol.rows[:, :kk]
            if survivors is not None:
                alive = torch.zeros((m,), dtype=torch.bool, device=dev)
                alive[list(survivors)] = True
                local_ids = torch.where(alive[:, None], local_ids, -1)
                local_cov = torch.where(alive, local_cov, -1)
                gain0 = torch.where(alive, gain0, 0.0)
                sent_rows = torch.where(alive[:, None, None], sent_rows, 0)
            sent_ids = local_ids[:, :kk]
            lower = float(gain0.max())        # the pmax of l over machines
        with StageClock(stats, "receiver_s", dev):
            state = streaming.init_state(k, delta, lower, w_global,
                                         device=dev)
            if aggregate == "gather":
                g_seeds, g_cov = _gather_receiver(
                    state, sent_ids.reshape(-1),
                    sent_rows.reshape(-1, w_global), k, use_kernel,
                    bucket_insert.auto_chunk_size(w_global, m * kk, dev)
                    if auto_chunk else chunk_size)
            else:
                g_seeds, g_cov = _ring_receivers(
                    state, sent_ids, sent_rows, k, use_kernel,
                    None if survivors is None else alive)
        with StageClock(stats, "merge_s", dev):
            l_best = torch.argmax(local_cov)
            best_local = local_cov[l_best]
            take_global = g_cov >= best_local
            seeds = torch.where(take_global, g_seeds, local_ids[l_best])
            cov = torch.maximum(g_cov, best_local)
        return GreediRISOut(seeds, cov, g_cov, best_local)

    fn.sample_shuffle = sample_shuffle
    return fn, n_pad, theta_local * m


def _gather_receiver(state, ids, rows, k: int, use_kernel: bool,
                     chunk_size):
    """One receiver over the whole [m*kk] stream, in source order."""
    total = ids.shape[0]
    if use_kernel:
        cs = min(chunk_size or total, total)
        state = streaming.insert_stream(
            state, *streaming.chunk_stream(ids, rows, cs), k)
    elif chunk_size and chunk_size < total:
        for ci, cr in zip(*streaming.chunk_stream(ids, rows, chunk_size)):
            state = streaming.insert_chunk(state, ci, cr, k)
    else:
        state = streaming.insert_chunk(state, ids, rows, k)
    return streaming.finalize(state)


def _ring_receivers(state0, sent_ids, sent_rows, k: int, use_kernel: bool,
                    alive):
    """m receivers; receiver j inserts the payload of machine j - r at
    ring step r.  Returns the first best receiver's (seeds, coverage);
    a dead machine's receiver never wins."""
    m = sent_ids.shape[0]
    seeds_all, cov_all = [], []
    for j in range(m):
        state = state0
        for r in range(m):
            src = (j - r) % m
            state = streaming.insert_chunk(state, sent_ids[src],
                                           sent_rows[src], k, use_kernel)
        s, c = streaming.finalize(state)
        seeds_all.append(s)
        cov_all.append(c)
    cov_all = torch.stack(cov_all)
    if alive is not None:
        cov_all = torch.where(alive, cov_all, -1)
    best = torch.argmax(cov_all)
    return torch.stack(seeds_all)[best], cov_all[best]


def build_ripples_round(*, m: int, n: int, theta: int, k: int,
                        model: str = "IC", max_steps: int = 32,
                        sample_chunks: int = 1, use_kernel: bool = False,
                        sampler: str | None = None, fwd=None,
                        coin_chunk: int = 32, gather: str = "auto",
                        lt=None):
    """The Ripples baseline over m machines on one device: returns
    ``(fn, theta)`` where ``fn(nbr, prob, wt, key, stats=None)`` ->
    (seeds int32 [k], coverage int32 []).  Machine p keeps its own
    theta/m samples ([m, n, w_local]); each pick sums the machines'
    gains (the ``coverage`` kernel under ``use_kernel``).  The
    reference's ``unroll_k`` (a dry-run HLO knob) has no counterpart;
    ``sampler``, ``fwd``, ``coin_chunk`` and ``gather`` choose the
    sampler, whose output equals the reference's dense one.  ``stats``
    gathers ``sample_s`` and ``select_s``; ``fn.sample(nbr, prob, wt,
    key)`` draws the machines' samples alone.  ``lt`` as in
    :func:`build_round`."""
    theta_local = _local_theta(theta, m, sample_chunks)
    w_local = theta_local // 32
    b = theta_local // sample_chunks
    sample = _machine_sampler(
        n=n, theta_local=theta_local, sample_chunks=sample_chunks,
        model=model, max_steps=max_steps, sampler=sampler, fwd=fwd,
        coin_chunk=coin_chunk, gather=gather, lt=lt)

    def sample_all(nbr, prob, wt, key):
        """Every machine's samples, int32 [m, n, w_local]."""
        x = torch.zeros((m, n, w_local), dtype=torch.int32,
                        device=rrr._device(nbr, lt))
        for p in range(m):
            for i in range(sample_chunks):
                x[p, :, i * b // 32:(i + 1) * b // 32] = sample(
                    nbr, prob, wt, key, p, i)[:n]
        return x

    def fn(nbr, prob, wt, key, stats=None):
        dev = rrr._device(nbr, lt)
        with StageClock(stats, "sample_s", dev):
            x = sample_all(nbr, prob, wt, key)
        with StageClock(stats, "select_s", dev):
            seeds, covered = randgreedi.ripples_picks(x, k, use_kernel)
            cov = bitset.coverage_size(covered).sum(dtype=torch.int32)
        return seeds, cov

    fn.sample = sample_all
    return fn, theta_local * m
