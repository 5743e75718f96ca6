#!/usr/bin/env python3
"""Time the IC sampler inside the full-size paths on one NVIDIA GPU.

    python3 tools/time_sampler.py [--src DIR] [--label NAME]

Runs ``chip_smoke.py``'s full-size commands through the entry points a
user calls: the IMM command (FULL), the same on the sampler's streamed
layout (FULL with ``--gather streamed``, whose steps draw the coin plane
and expand through the gathered mask: the device seconds of each kernel
wrapper over the run are printed apart), the fixed-theta round (ROUND,
lazy sender) and the serving replay (SERVE, lazy sender).  For each it
prints the stage seconds, the peak device memory, the kernel launches
and a digest of the result (seeds, or every answer).  It also times the
coin plane's kernel alone (``coins.coin_plane``) at FULL's first BFS
step, CUDA-event median of 10 launches, with a digest of the plane, and
the two plane expansions over that plane (``rrr_expand_step`` on its
gathered mask, zero at invalid slots, and ``rrr_expand_step_resident``
on the plane itself; a version whose wrappers take a per-row count of
valid slots and a line summary is given ``t.slots`` and the roots'
summary), with a digest of each one's words.  The serving
replay's refreshes are split into the slab fills' sampler kernels (CUDA
events around every call of the sampler's kernel wrappers), the host
tables (``padded_adjacency``, ``padded_forward_adjacency`` and the
per-fill ``rrr._Tables``, each between two synchronizations) and the
rest (roots, keys, the BFS loop's host syncs, concatenation).  A
version whose sampler calls the dense ``rrr_expand_step_ic`` (the pull,
before the push) is timed through that wrapper instead.

The three paths run twice in the process (``rep`` 0 and 1): the first
pass pays the CUDA context, the kernels' loading and (for a version
whose kernels are not built yet) ``nvcc``, so compare the second.
``--src`` names the ``src`` directory whose ``repro_torch`` runs
(default: this checkout's), so two versions can be compared in one
machine session: run them alternately (A, B, B, A); equal digests mean
equal seeds and answers.  Prints the card line, then one JSON line per
path and pass.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ast
import hashlib
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (module, function) of every kernel wrapper an RRR step may call; the
# ones a version lacks are skipped.  The pushes (rrr_expand_push_ic,
# rrr_expand_push_lt) leave their count on the card, so their events
# bracket the launch alone.
KERNEL_FNS = (("rrr_expand", "rrr_expand_push_ic"),
              ("rrr_expand", "rrr_expand_push_lt"),
              ("rrr_expand", "rrr_expand_step_ic"),
              ("rrr_expand", "rrr_expand_step_resident"),
              ("rrr_expand", "rrr_expand_step"),
              ("coins", "coin_plane"))


class SamplerClock:
    """While open, brackets every call of the sampler's kernel wrappers
    with CUDA events and every build of its tables with a synchronized
    host clock.  ``modules`` maps ``rrr``, ``rrr_expand``, ``coins`` and
    ``service`` to the modules of the version under test."""

    def __init__(self, modules: dict):
        self.modules = modules
        self.events = []            # (wrapper name, start, stop)
        self.tables_s = 0.0
        self._saved = []

    def __enter__(self):
        for mod, name in KERNEL_FNS:
            if hasattr(self.modules[mod], name):
                self._wrap(self.modules[mod], name,
                           lambda fn, name=name: self._on_card(fn, name))
        for name in ("padded_adjacency", "padded_forward_adjacency"):
            self._wrap(self.modules["service"], name, self._on_host)
        self._wrap(self.modules["rrr"], "_Tables", self._on_host)
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self._saved):
            setattr(module, name, fn)
        self._saved.clear()

    def _wrap(self, module, name, how):
        fn = getattr(module, name)
        self._saved.append((module, name, fn))
        setattr(module, name, how(fn))

    def _on_card(self, fn, name: str):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            stop.record()
            self.events.append((name, start, stop))
            return out
        return timed

    def _on_host(self, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.tables_s += time.perf_counter() - t0
            return out
        return timed

    def kernel_s(self, name: str | None = None) -> float:
        """Device seconds of the wrapper calls (of ``name`` alone)."""
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for fn, a, b in self.events
                   if name in (None, fn)) / 1e3


def smoke_commands() -> dict:
    """FULL, ROUND and SERVE as ``chip_smoke.py`` defines them (read from
    its source: importing it would import this checkout's package)."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    return {t.id: ast.literal_eval(node.value) for node in tree.body
            if isinstance(node, ast.Assign) for t in node.targets
            if isinstance(t, ast.Name) and t.id in ("FULL", "ROUND", "SERVE")}


def digest(items) -> str:
    return hashlib.sha256(repr(items).encode()).hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_sampler: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cmd = smoke_commands()
    for rep in (0, 1):
        run_paths(dict(label=args.label, src=args.src, rep=rep), cmd, dev)
    first_step(dict(label=args.label, src=args.src), cmd, dev)
    return 0


def event_ms(fn, reps: int) -> float:
    """Median CUDA-event ms of ``fn`` over ``reps`` calls after one."""
    import numpy as np
    times = []
    for _ in range(reps + 1):                   # the first is a warm-up
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times[1:]))


def first_step(common: dict, cmd: dict, dev, reps: int = 10):
    """coin_pack at the first BFS step of FULL's draw (its 32,768 roots,
    the chunk keys as the sampler derives them): the plane [n, d_pad, W]
    of that step; then the two plane expansions over it.  One JSON line
    each."""
    import inspect
    from repro_torch.core import prng, rrr
    from repro_torch.graphs import csr, generators
    from repro_torch.kernels import coins, rrr_expand
    from repro_torch.launch import im_driver

    args = im_driver.parser().parse_args(cmd["FULL"])
    g = generators.erdos_renyi(args.n, args.avg_deg, args.seed, device=dev)
    nbr, prob, wt = csr.padded_adjacency(g)
    t = rrr._Tables(nbr, prob, wt, *csr.padded_forward_adjacency(g),
                    model="IC", coin_chunk=args.coin_chunk)
    kr, kb = prng.key(args.seed).fold_in(1).split()
    frontier = rrr.packed_roots(
        kr.randint((args.max_theta,), 0, t.n, device=dev), t.n)
    keys = [kb.split()[1].fold_in(c) for c in range(t.n_chunks)]

    def plane():
        return coins.coin_plane(keys, t.prob_p, frontier, t.chunk)

    out = plane()
    slots = torch.arange(out.shape[1], device=dev, dtype=torch.int64)
    check = [int(out.ne(0).sum()), int(out.sum(dtype=torch.int64)),
             int((out.sum(2, dtype=torch.int64) * slots).sum())]
    del out
    print(json.dumps(dict(
        common, path="coin_pack first step", shape=[t.n, t.d_pad,
                                                    frontier.shape[1]],
        ms=event_ms(plane, reps), plane=digest(check))), flush=True)

    w = frontier.shape[1]
    coin = plane()
    gm = torch.where(t.valid[:, :, None], coin[t.nbr_c.long(), t.rslot], 0)
    coin = coin.reshape(t.n * t.d_pad, w)
    opts = {}
    if "slots" in inspect.signature(rrr_expand.rrr_expand_step).parameters:
        opts = dict(slots=t.slots, lines=rrr_expand.line_summary(frontier))
    for name, fn in (
            ("rrr_expand_streamed", lambda: rrr_expand.rrr_expand_step(
                frontier, frontier, t.nbr_c, gm, **opts)),
            ("rrr_expand_resident",
             lambda: rrr_expand.rrr_expand_step_resident(
                 frontier, frontier, t.nbr_c, t.gidx, coin, **opts))):
        new, vis = fn()
        words = [int(new.ne(0).sum()), int(new.sum(dtype=torch.int64)),
                 int(vis.sum(dtype=torch.int64))]
        del new, vis
        print(json.dumps(dict(
            common, path=f"{name} first step", shape=list(gm.shape),
            inputs=sorted(opts), ms=event_ms(fn, reps),
            words=digest(words))), flush=True)


def run_paths(common: dict, cmd: dict, dev):
    """The IMM, round and serve commands once, with ``--src``'s package
    (on ``sys.path``); one JSON line each."""
    from repro_torch.core import rrr, service
    from repro_torch.kernels import coins, ops, rrr_expand
    from repro_torch.launch import im_driver, serve

    modules = dict(rrr=rrr, rrr_expand=rrr_expand, coins=coins,
                   service=service)
    for path, argv_ in (("imm", cmd["FULL"]),
                        ("imm streamed", cmd["FULL"] + ["--gather",
                                                        "streamed"]),
                        ("round", cmd["ROUND"])):
        ops.reset_launches()
        with SamplerClock(modules) as clock:
            out = im_driver.run(argv_)
            torch.cuda.synchronize()
            wrappers_s = {fn: clock.kernel_s(fn)
                          for fn in dict.fromkeys(e[0] for e in clock.events)}
        rnd = out["round"]
        print(json.dumps(dict(
            common, path=path, sample_s=out["sample_s"],
            select_s=out["select_s"],
            round_seconds=rnd["seconds"] if rnd else None,
            bfs_steps=out["bfs_steps"], peak_bytes=out["peak_bytes"],
            wrapper_device_s=wrappers_s,
            launches={k: v for k, v in ops.LAUNCHES.items() if v},
            seeds=digest(out["seeds"].tolist()))), flush=True)
        del out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    with SamplerClock(modules) as clock:
        out = serve.run(cmd["SERVE"] + ["--solver", "lazy"])
        kernel_s = clock.kernel_s()
    st = out["stats"]
    print(json.dumps(dict(
        common, path="serve", rc=out["rc"], elapsed_s=out["elapsed_s"],
        queries_per_s=len(out["answers"]) / out["elapsed_s"],
        refreshes=st["refreshes"], refresh_s=st["refresh_s"],
        sampler_kernel_s=kernel_s, sampler_calls=len(clock.events),
        tables_s=clock.tables_s,
        rest_s=st["refresh_s"] - kernel_s - clock.tables_s,
        solve_s=st["solve_s"],
        peak_bytes=torch.cuda.max_memory_allocated(dev),
        launches={k: v for k, v in ops.LAUNCHES.items() if v},
        answers=digest([(a.seeds.tolist(), tuple(a[1:]))
                        for a in out["answers"]]))), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
