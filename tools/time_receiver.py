#!/usr/bin/env python3
"""Time the streaming receiver's two kernels on one NVIDIA GPU.

    python3 tools/time_receiver.py [--src DIR] [--label NAME] [--layouts]
                                   [--end-to-end N]

Builds the receiver inputs of ``chip_smoke.py``'s full-size runs: the
IMM selector's chunk (``bucket_insert``: machine 0..7's 100 picks each
from the local solves over a 32,768-sample draw, W = 1,024) and the lazy
round's stream (``bucket_insert_stream``: the 800 picks of the lazy
senders, W = 4,096, cut into the pipelined receiver's chunks), on ER n =
262,144 at avg degree 4 and on the supercritical configuration (ER n =
32,768 at avg degree 76.3, IMM and the round at theta = 32,768, W =
1,024); k = 100, delta = 0.077 (63 buckets).  Times each kernel as its
wrapper runs it and prints a digest of the outputs: runs of two versions
on the same inputs must print the same digests.  Where the version has
the grouped launch, it also prints the launch's figures
(:func:`summary`), and with ``--layouts`` times every group size, with
one block a bucket and with a cluster of two blocks splitting its
words, each a build of the CUDA source with its layout fixed by
``-DRECV_GROUP`` and ``-DRECV_CLUSTER`` (:func:`layout_libraries`).
Times are CUDA-event medians of the device time (``tools/timing.py``: a
spin kernel hides the host's time to queue the launch; ``wrapper_ms``
keeps it).
``no_candidates_ms`` is the launch with every id -1 (its set-up and
exit alone).  ``--buckets`` times the launch on the first B buckets of
each state too.
``--end-to-end N`` instead runs ``chip_smoke.py``'s IMM command and its
round with the lazy and the fused senders N times each through
``im_driver.run`` and prints the stages around the receivers (IMM
``select_s``, the round's ``receiver_s``), their launches and a digest
of the seeds.  ``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so two versions can be compared on one
machine in one run: run them alternately (A, B, B, A).  Prints the card
line, then one JSON line per input and layout.  Exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, n, avg degree, IMM theta, round theta) of chip_smoke.py's FULL
# / ROUND and DENSE_FULL / DENSE_ROUND commands.
CONFIGS = (("", 262144, 4.0, 32768, 131072),
           (" supercritical", 32768, 76.3, 32768, 32768))
K, DELTA, M = 100, 0.077, 8

def digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def emit(**fields):
    print(json.dumps(fields), flush=True)


def imm_chunk(local_rows, assign, dev):
    """(ids [800], rows [800, W], state) the IMM selector's fused receiver
    gets from the resident local solves over ``local_rows``."""
    from repro_torch.core import maxcover, streaming
    w = local_rows.shape[2]
    local = maxcover.greedy_maxcover(local_rows, K, solver="resident")
    ids = torch.where(local.seeds >= 0, torch.gather(
        assign, 1, local.seeds.clamp(min=0).long()).to(torch.int32), -1
    ).reshape(-1).contiguous()
    st = streaming.init_state(K, DELTA, float(local.gains[:, 0].max()), w,
                              device=dev)
    return ids, local.rows.reshape(-1, w).contiguous(), st


def round_stream(x_s, perm, dev):
    """(ids [R, C], rows [R, C, W], state) the lazy round's pipelined
    receiver gets from the lazy senders over the shuffled rows ``x_s``."""
    from repro_torch.core import streaming
    from repro_torch.kernels import bucket_insert, greedy_pick, lazy_greedy
    m, per, w = x_s.shape
    ex = greedy_pick.excluded_ids(None, m, dev)
    seeds, rows, _, gains = lazy_greedy.greedy_maxcover_lazy(x_s, K, ex)[:4]
    ids = torch.where(seeds >= 0, perm.reshape(m, per).gather(
        1, seeds.clamp(min=0).long()), -1).to(torch.int32).reshape(-1)
    st = streaming.init_state(K, DELTA, float(gains[:, 0].max()), w,
                              device=dev)
    cs = bucket_insert.auto_chunk_size(w, ids.numel(), dev)
    return (*streaming.chunk_stream(ids, rows.reshape(-1, w), cs), st)


def regime_arrays(regime: str, c: int, b: int, w: int, k: int, seed: int):
    """A synthetic input of one of the full-size runs' two regimes, numpy
    (ids int32 [c], rows uint32 [c, w], covers uint32 [b, w], counts,
    seeds int32 [b, k], thresholds float32 [b]) with b empty buckets:
    ``filling``, rows of 3 new bits each (disjoint for the first 32 w /
    3) and thresholds at most 1, so every bucket takes the first k
    candidates; ``rejecting``, a first row that covers every bit of the
    dense rows after it (random words from ``seed``), so every bucket
    takes one candidate."""
    if regime == "filling":
        rows = np.zeros((c, w), np.uint32)
        for i in range(c):
            for bit in range(3 * i, 3 * i + 3):
                bit %= 32 * w
                rows[i, bit // 32] |= np.uint32(1 << (bit % 32))
        thr = np.linspace(0.25, 1.0, b)
    else:
        rng = np.random.default_rng(seed)
        rows = rng.integers(0, 2**32, (c, w), dtype=np.uint32)
        rows[:, -1] = 0
        rows[0, :-1] = 0xFFFFFFFF
        thr = np.linspace(2.0, 8.0 * max(w - 1, 1), b)
    return (np.arange(c, dtype=np.int32), rows,
            np.zeros((b, w), np.uint32), np.zeros(b, np.int32),
            np.full((b, k), -1, np.int32), thr.astype(np.float32))


def regime_inputs(regime: str, c: int, b: int, w: int, k: int, dev):
    """:func:`regime_arrays` (seed c + w) as tensors on ``dev``, the
    words as int32."""
    return tuple(torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32
                                  else x).to(dev)
                 for x in regime_arrays(regime, c, b, w, k, c + w))


def layout_libraries() -> dict:
    """{(group, cluster): the receiver library built with that layout}:
    ``csrc/bucket_insert.cu`` of the imported ``repro_torch`` compiled
    with ``-DRECV_GROUP`` (1, 2, 4, ..., 32) and ``-DRECV_CLUSTER`` (1:
    one block a bucket, 2: a cluster of two splitting its words), one
    ``nvcc`` each, all started together, into the build directory."""
    from repro_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for g in (1, 2, 4, 8, 16, 32):
        for cs in (1, 2):
            out = build.BUILD_DIR / f"libbucket_insert-layout-g{g}c{cs}.so"
            cmd = [build._nvcc(), *build.FLAGS, f"-DRECV_GROUP={g}",
                   f"-DRECV_CLUSTER={cs}", "-I", str(build.CSRC), "-o",
                   str(out), str(build.CSRC / "bucket_insert.cu")]
            jobs[g, cs] = out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    libs = {}
    for layout, (out, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for layout {layout}:\n{log}")
        libs[layout] = ctypes.CDLL(str(out))
    return libs


def receiver_inputs(seed: int, dev):
    """{input name: (ids, rows, state)} of the full-size and
    supercritical IMM and lazy round runs."""
    from repro_torch.core import greediris, prng, rrr
    from repro_torch.graphs import csr, generators

    out = {}
    for label, n, deg, imm_theta, round_theta in CONFIGS:
        g = generators.erdos_renyi(n, deg, seed, device=dev)
        nbr, prob, wt = csr.padded_adjacency(g)
        fwd = csr.padded_forward_adjacency(g)
        inc = rrr.sample_incidence(nbr, prob, wt, prng.key(seed).fold_in(1),
                                   theta=imm_theta, n=n, model="IC", fwd=fwd)
        perm = prng.key(seed).fold_in(0xC0FFEE).fold_in(1).permutation(
            n, device=dev)
        assign = perm[:(n // M) * M].reshape(M, n // M).long()
        local_rows = inc[assign].contiguous()
        del inc
        out["imm" + label] = imm_chunk(local_rows, assign, dev)
        del local_rows
        fn, _, _ = greediris.build_round(m=M, n=n, theta=round_theta, k=K,
                                         max_degree=0, model="IC",
                                         sampler="kernel", fwd=fwd)
        x_s, rperm = fn.sample_shuffle(nbr, prob, wt, prng.key(seed))
        out["round" + label] = round_stream(x_s, rperm, dev)
        del x_s, g, nbr, prob, wt, fwd
        torch.cuda.empty_cache()
    return out


def summary(ids, rows, st, counts, stats) -> dict:
    """The grouped launch's figures: its layout, the passes on the
    critical path (the most of any bucket) and their ceiling (ceil(N / G)
    plus that bucket's ambiguous candidates), the accepts per bucket,
    the candidate at which the last bucket filled (None: some bucket
    never filled), the bytes of rows the passes read from L2 (summed
    over buckets) and the bytes staged into shared memory (none: the
    rows go from L2 to registers)."""
    s = stats.cpu().long()
    n, w = ids.numel(), rows.shape[-1]
    g = int(s[0, 4])
    ceiling = -(-n // g) + s[:, 1]
    if (s[:, 0] > ceiling).any():
        raise AssertionError("a bucket took more passes than its ceiling")
    accepts = (counts - st.counts).cpu()
    filled = s[:, 2]
    return dict(group=g, cluster=int(s[0, 5]), passes=int(s[:, 0].max()),
                passes_ceiling=int(ceiling[s[:, 0].argmax()]),
                ambiguous_max=int(s[:, 1].max()),
                accepts_min=int(accepts.min()), accepts_max=int(accepts.max()),
                full_buckets=int((filled >= 0).sum()),
                last_filled_at=int(filled.max()) if (filled >= 0).all()
                else None,
                bytes_read=int(s[:, 3].sum()) * 4 * w, staged_bytes=0)


def end_to_end(args) -> int:
    """The IMM command and the round (lazy, fused senders) of
    ``chip_smoke.py``, ``args.end_to_end`` times each, one JSON line a
    run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import im_driver
    from tools.time_sampler import digest as seeds_digest
    from tools.time_sampler import smoke_commands
    cmd = smoke_commands()
    runs = (("imm", cmd["FULL"]), ("round lazy", cmd["ROUND"]),
            ("round fused", [("fused" if a == "lazy" else a)
                             for a in cmd["ROUND"]]))
    for rep in range(args.end_to_end):
        for path, argv_ in runs:
            ops.reset_launches()
            out = im_driver.run(argv_)
            torch.cuda.synchronize()
            rnd = out["round"]
            emit(label=args.label, rep=rep, path=path,
                 select_s=out["select_s"],
                 receiver_s=rnd["seconds"]["receiver"] if rnd else None,
                 launches={k: v for k, v in ops.LAUNCHES.items()
                           if k.startswith("bucket_insert") and v},
                 seeds=seeds_digest(out["seeds"].tolist()))
            del out
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--layouts", action="store_true",
                    help="time every group size and cluster size")
    ap.add_argument("--end-to-end", type=int, default=0, metavar="N",
                    help="time the full-size IMM and round commands N "
                         "times each instead")
    ap.add_argument("--buckets", type=int, nargs="*", default=(),
                    help="also time the launch on the first B buckets of "
                         "each state, for each B given")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_receiver: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    from repro_torch.kernels import build, bucket_insert
    from tools.timing import median_ms
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.end_to_end:
        return end_to_end(args)
    grouped = hasattr(bucket_insert, "bucket_insert_with_stats")
    libs = layout_libraries() if grouped and args.layouts else {}
    for name, (ids, rows, st) in receiver_inputs(args.seed, dev).items():
        stream = ids.dim() == 2
        kernel = "bucket_insert_stream" if stream else "bucket_insert"
        wrapper = (bucket_insert.bucket_insert_stream if stream
                   else bucket_insert.bucket_insert_chunk)
        outs = wrapper(ids, rows, *st)
        row = dict(label=args.label, input=name, kernel=kernel,
                   candidates=ids.numel(), W=rows.shape[-1],
                   B=st.covers.shape[0],
                   ms=median_ms(lambda: wrapper(ids, rows, *st), args.reps,
                                hide_host=True),
                   wrapper_ms=median_ms(lambda: wrapper(ids, rows, *st),
                                        args.reps),
                   outputs=digest(outs))
        if grouped:
            *_, stats = bucket_insert.bucket_insert_with_stats(ids, rows, *st)
            row.update(summary(ids, rows, st, outs[1], stats))
        none = torch.full_like(ids, -1)    # no candidate: launch and set-up
        row["no_candidates_ms"] = median_ms(
            lambda: wrapper(none, rows, *st), args.reps, hide_host=True)
        emit(**row)
        for nb in args.buckets:       # how the time grows with the blocks
            part = type(st)(*(x[:nb] for x in st))
            emit(label=args.label, input=name, kernel=kernel, B=nb,
                 ms=median_ms(lambda: wrapper(ids, rows, *part), args.reps,
                              hide_host=True))
        default = build._loaded["bucket_insert"]
        try:
            for (g, cs), lib in libs.items():
                build._loaded["bucket_insert"] = lib
                got = bucket_insert.bucket_insert_with_stats(ids, rows, *st)
                if digest(got[:3]) != row["outputs"]:
                    raise AssertionError(f"{name}: layout {g}/{cs} differs")
                emit(label=args.label, input=name, kernel=kernel,
                     ms=median_ms(lambda: wrapper(ids, rows, *st),
                                  args.reps, hide_host=True),
                     **summary(ids, rows, st, got[1], got[3]))
        finally:
            build._loaded["bucket_insert"] = default
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
