#!/usr/bin/env python3
"""Split the spread estimate into its parts on one NVIDIA GPU.

    python3 tools/time_spread.py [--reps N] [--gathers auto,streamed]
        [--model IC|LT|WC] [--commands imm,supercritical] [--src DIR]
        [--label NAME]

Runs ``chip_smoke.py``'s IMM command (FULL) and its supercritical IMM
command (DENSE_FULL) through ``im_driver.run``, for their seeds and the
spread's end-to-end seconds there, then estimates the spread again on
the same graph, seeds and key with each ``--gather`` of the cascade
(the kernel engine, ``--model``, 64 simulations), ``--reps`` times after
one warm-up, under a :class:`SpanClock` set as the cascade module's
measurement hook (``cascade._clock``).  The clock spans each part that
``cascade.simulate_cascades`` names — the host build of the padded
adjacency, the key table or the gather table and live-edge plane, each
step's kernel, each step's host sync (on the kernel's count of new
words, or on the frontier) — and the final
popcount, with CUDA events (device ms: from the span's start to its
end on the stream, idle time included) and the host clock (host ms).
Prints the card line, then one JSON line per command and gather with
the medians over the reps; equal spreads across gathers (and, under the
command's own model, the driver's) are checked.  ``--src`` names the
``src`` directory whose ``repro_torch`` runs (default: this checkout's),
so two versions can be compared in one machine session, run alternately
(A, B, B, A) with ``--label``; equal spreads mean equal results.  Exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class SpanClock:
    """The cascade module's measurement hook: CUDA events and the host
    clock around each named part, summed by name."""

    def __init__(self):
        self.spans = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            host = time.perf_counter() - t0
            stop.record()
            self.spans.append((name, start, stop, host))

    def split(self) -> dict:
        """{name: {device_ms, host_ms, count}} (synchronizes)."""
        torch.cuda.synchronize()
        out = {}
        for name, start, stop, host in self.spans:
            e = out.setdefault(name, dict(device_ms=0.0, host_ms=0.0,
                                          count=0))
            e["device_ms"] += start.elapsed_time(stop)
            e["host_ms"] += host * 1e3
            e["count"] += 1
        return out


def split_spread(g, seeds, key, *, gather: str, reps: int = 3,
                 model: str = "IC", num_sims: int = 64) -> dict:
    """The spread of ``seeds`` on ``g`` through the kernel engine with
    ``gather``, once untimed, then ``reps`` times under a
    :class:`SpanClock`: the median of each part's device and host ms, of
    the whole call's wall ms (synchronized) and the kernel launches of
    one call."""
    from repro_torch.core import cascade
    from repro_torch.kernels import ops

    def once(clock=None):
        cascade._clock = clock
        try:
            return float(cascade.spread(g, seeds, key, model=model,
                                        num_sims=num_sims, engine="kernel",
                                        gather=gather))
        finally:
            cascade._clock = None

    value = once()
    splits, walls = [], []
    for _ in range(reps):
        ops.reset_launches()
        clock = SpanClock()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = once(clock)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if got != value:
            raise AssertionError(f"spread {got} != {value} ({gather})")
        splits.append(clock.split())
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    parts = {name: {field: float(np.median([s[name][field] for s in splits]))
                    for field in ("device_ms", "host_ms", "count")}
             for name in splits[0]}
    return dict(gather=gather, spread=value, wall_ms=float(np.median(walls)),
                parts=parts, launches=launches,
                parts_host_ms=sum(p["host_ms"] for p in parts.values()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--gathers", default="auto,streamed")
    ap.add_argument("--model", default="IC", choices=("IC", "LT", "WC"))
    ap.add_argument("--commands", default="imm,supercritical")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_spread: no CUDA device", file=sys.stderr)
        return 2
    # the package of --src first: chip_smoke then finds it imported and
    # takes its modules from there, not from this checkout's src
    sys.path.insert(0, os.path.abspath(args.src))
    import repro_torch  # noqa: F401
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.core import prng
    from repro_torch.launch import im_driver

    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line(), flush=True)
    commands = {"imm": chip_smoke.FULL,
                "supercritical": chip_smoke.DENSE_FULL}
    for label in args.commands.split(","):
        argv_ = commands[label]
        out = im_driver.run(argv_)
        torch.cuda.synchronize()
        a = im_driver.parser().parse_args(argv_)
        g = im_driver.make_graph(a.graph, a.n, a.avg_deg, a.seed, dev)
        seeds = torch.from_numpy(out["seeds"])
        key = prng.key(a.seed).fold_in(99)
        values = set()
        for gather in args.gathers.split(","):
            row = split_spread(g, seeds, key, gather=gather, reps=args.reps,
                               model=args.model, num_sims=a.eval_sims)
            values.add(row["spread"])
            print(json.dumps(dict(label=args.label, src=args.src,
                                  command=label, model=args.model, n=a.n,
                                  edges=g.num_edges,
                                  driver_spread=out["spread"],
                                  driver_spread_s=out["spread_s"], **row)),
                  flush=True)
        if len(values) != 1 or (args.model == a.model
                                and values != {out["spread"]}):
            raise AssertionError(f"{label}: spreads {values} against the "
                                 f"driver's {out['spread']}")
        del g, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
