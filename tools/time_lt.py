#!/usr/bin/env python3
"""Time the LT kernels' steps and the LT sampling and spread on one NVIDIA GPU.

    python3 tools/time_lt.py [--src DIR] [--label NAME] [--reps N]

On ``chip_smoke.py``'s LT IMM graph (LT_FULL: ER, n = 262,144, average
degree 4, short rows) and on the same size drawn as rmat (hub rows),
times with CUDA events, the host's queueing hidden: rrr_expand_lt at
the first step of a 32,768-sample draw, and cascade_lt at the first
step of a 64-simulation spread from 100 random seeds and at a step with
every frontier word live.  Then, on the host clock with the card
synchronized, one whole LT sampling call (``rrr.sample_incidence``,
32,768 samples, IMM's 32 steps) and one whole LT spread
(``cascade.simulate_cascades``, 64 simulations) on each graph.  Prints
the card line, then one JSON line per graph with the medians of
``--reps`` runs and a digest of the sampled words and of the spread.

``--src`` names the ``src`` directory whose ``repro_torch`` runs
(default: this checkout's), so two versions of the kernels can be
compared in one machine session: run them alternately (A, B, B, A);
equal digests mean equal results.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def digest(x: torch.Tensor) -> str:
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]


def wall_ms(fn, reps: int):
    """(median host ms of ``fn`` with the card synchronized, its last
    result), after one warm-up."""
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def time_graph(graph: str, reps: int, dev) -> dict:
    import chip_smoke as cs
    from repro_torch.core import cascade, prng, rrr
    from repro_torch.kernels import rrr_expand
    from repro_torch.launch import im_driver
    from tools.timing import median_ms

    args = im_driver.parser().parse_args(cs.at_scale(cs.LT_FULL,
                                                     graph=graph))
    g = im_driver.make_graph(graph, args.n, args.avg_deg, args.seed, dev)
    key = prng.key(args.seed).fold_in(1)
    t = cs.lt_sampler_tables(g, args.coin_chunk, forward=False)
    frontier, visited, sub = cs.lt_first_step(t, key, args.max_theta, dev)
    n, w = frontier.shape
    words = rrr_expand.live_words(frontier)
    f, vis, nxt = (torch.empty_like(frontier) for _ in range(3))
    listed = torch.empty(n * w, dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)

    def restore():
        f.copy_(frontier)
        vis.copy_(visited)
        nxt.zero_()

    row = dict(graph=graph, n=n, d=t.d, edges=t.lt.num_edges)
    row["push_first_step_ms"] = median_ms(
        lambda: rrr_expand.rrr_expand_push_lt(
            words, f, vis, t.lt.indptr, t.lt.src, t.lt.cumw, sub, nxt, listed,
            count),
        reps, restore, hide_host=True)
    del f, vis, nxt, listed, t, frontier, visited

    gen = torch.Generator().manual_seed(0)
    seeds = torch.randperm(n, generator=gen)[:100]
    ckey = prng.key(args.seed).fold_in(99)
    for label, how in (("first", dict(seeds=seeds)),
                       ("every_word_live", dict(gen=gen))):
        step, sf, svis = cs.cascade_step(g, args.eval_sims, args.coin_chunk,
                                         dev, ckey, model="LT", **how)
        row[f"cascade_{label}_step_ms"] = median_ms(
            lambda: cs.run_cascade_step(step, sf, svis), reps,
            hide_host=True)
        del step, sf, svis

    lt = rrr.graph_tables(g, "kernel", model="LT")[4]
    row["sample_ms"], inc = wall_ms(lambda: rrr.sample_incidence(
        None, None, None, key, theta=args.max_theta, n=n, model="LT",
        max_steps=32, lt=lt), reps)
    row["sample_digest"] = digest(inc)
    del inc, lt     # the rmat graph's spread needs the room
    torch.cuda.empty_cache()
    row["spread_ms"], act = wall_ms(lambda: cascade.simulate_cascades(
        g, seeds, ckey, model="LT", num_sims=args.eval_sims), reps)
    row["spread_digest"] = digest(act)
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_lt: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    import repro_torch.kernels.rrr_expand  # noqa: F401  (--src's package)
    sys.path.insert(1, ROOT)
    import chip_smoke

    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line(), flush=True)
    for graph in ("er", "rmat"):
        print(json.dumps(dict(label=args.label, src=args.src,
                              **time_graph(graph, args.reps, dev))),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
