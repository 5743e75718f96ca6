#!/usr/bin/env python3
"""Time the serving batch's two sender kernels on one NVIDIA GPU.

    python3 tools/time_query_solves.py [--src DIR] [--label NAME]

Builds a pool of the serve phase's final size (``chip_smoke.py``'s
SERVE command: ER n = 262,144, avg degree 4, IC, 131,072 samples per
half, so W = 4,096 words) with ``service.make_pool``, then times
``greedy_maxcover_resident_batch`` and ``greedy_maxcover_lazy_batch``
(CUDA-event medians) on three inputs: the trace's last 8 queries
(k = 96), a batch whose exclusions make the 8 queries' picks diverge,
and a dense random pool (n = 32,768, about a sixteenth of the bits set)
where few 16-byte chunks are zero.  The two solvers compute one function,
so each input checks that they agree bit for bit and prints a digest of
the outputs: runs of two versions of the kernels on the same inputs
must print the same digests.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so two versions can be compared in one
machine session: run them alternately (A, B, B, A).  Prints the card
line, then one JSON line per input and solver.  Exits non-zero without
a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def median_ms(fn, reps: int) -> float:
    fn()                                            # warm-up
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_query_solves: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core import prng, service
    from repro_torch.graphs import generators
    from repro_torch.kernels import build, greedy_pick, lazy_greedy
    from repro_torch.launch import serve

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    gain_core = os.path.join(os.path.dirname(build.__file__), "csrc",
                             "gain_core.cuh")
    with open(gain_core, "rb") as f:
        version = hashlib.sha256(f.read()).hexdigest()[:12]
    build.build(("coin_pack", "rrr_expand", "greedy_pick", "lazy_greedy"))

    n, theta, bq = 262_144, 131_072, 8
    g = generators.erdos_renyi(n, 4, args.seed, device=dev)
    pool = service.make_pool(g, prng.key(args.seed), theta=theta, slab=4096)
    r1 = pool.r1
    del pool
    trace = serve.make_trace(n, 32, args.seed + 1, k_max=100)
    k, excl, _, _ = service._query_arrays(trace[-bq:], n, theta)
    ex = torch.from_numpy(excl).to(dev)
    # query q keeps every 8th of the first 96 unconstrained seeds and
    # excludes the other 84 (chip_smoke.py's diverging batch)
    none = torch.full((1, 1), -1, dtype=torch.int32, device=dev)
    top = lazy_greedy.greedy_maxcover_lazy_batch(r1, 12 * bq, none)[0][0]
    keep = torch.arange(12 * bq, device=dev) % bq
    ex_div = torch.stack([top[keep != q] for q in range(bq)]).contiguous()
    gen = torch.Generator().manual_seed(args.seed)
    dense = torch.randint(-2**31, 2**31 - 1, (32_768, 4096), generator=gen,
                          dtype=torch.int32)
    for _ in range(3):
        dense &= torch.randint(-2**31, 2**31 - 1, dense.shape, generator=gen,
                               dtype=torch.int32)
    dense = dense.to(dev)

    for name, rows, exc, kk in (("trace", r1, ex, k),
                                ("diverging", r1, ex_div, k),
                                ("dense", dense, ex, 32)):
        res = greedy_pick.greedy_maxcover_resident_batch(rows, kk, exc)
        *lazy, swept = lazy_greedy.greedy_maxcover_lazy_batch(rows, kk, exc)
        if any(not torch.equal(a, b) for a, b in zip(res, lazy)):
            raise AssertionError(f"{name}: resident and lazy solves differ")
        for solver, fn in (
                ("greedy_pick_batch", lambda: greedy_pick.
                 greedy_maxcover_resident_batch(rows, kk, exc)),
                ("lazy_greedy_batch", lambda: lazy_greedy.
                 greedy_maxcover_lazy_batch(rows, kk, exc))):
            print(json.dumps(dict(
                label=args.label, gain_core=version, input=name,
                kernel=solver, B=bq, n=rows.shape[0], W=rows.shape[1], k=kk,
                ms=median_ms(fn, args.reps), outputs=digest(res),
                tiles_swept=swept.tolist() if solver.startswith("lazy")
                else None)), flush=True)
        del res, lazy
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
