#!/usr/bin/env python3
"""Time the sender solves on one NVIDIA GPU.

    python3 tools/time_solves.py [--axis query|machine|sweep|handover]
                                 [--src DIR]
                                 [--label NAME] [--shapes NAME ...]

``--axis query`` (the default): the serving batch's sender kernels.
Builds a pool of the serve phase's final size (``chip_smoke.py``'s SERVE
command: ER n = 262,144, avg degree 4, IC, 131,072 samples per half, so
W = 4,096 words) with ``service.make_pool``, then times
``greedy_maxcover_resident_batch``, ``greedy_maxcover_lazy_batch``, the
fused solver's one pick (``topk_gain.best_gain_index_batch``, zero
covers, the exclusions picked) and its whole solve
(``maxcover.greedy_maxcover_batch(..., solver="fused")``, one pick a
launch) on three inputs: the trace's last 8 queries (k = 96), a batch
whose exclusions make the 8 queries' picks diverge, and a dense random
pool (n = 32,768, about a sixteenth of the bits set) where few 16-byte
chunks are zero.

``--axis machine``: the machine-axis solves (``greedy_maxcover_resident``,
``greedy_maxcover_lazy``) as the wrappers run them, on the rows that
``chip_smoke.py``'s full-size runs give them: the IMM selector's local
rows ([8, 32768, 1024]) and the fixed-theta round's shuffled rows ([8,
32768, 4096]) of ER n = 262,144 at avg degree 4, and the supercritical
configuration's (ER n = 32,768 at avg degree 76.3: IMM [8, 4096, 1024],
the round at theta = 32,768 [8, 4096, 1024]; ``--shapes`` names some of
them).  Where this version has the compact layout it also times the
compaction alone and each layout of each solve forced; where its dense
solves hand over to the compact picks, also the dense sweep forced to
the end (``cap=0``), with the handover's pick and the residual counts.

``--axis sweep``: the layout rule's measurements.  Rows whose words are
non-zero with a given share (each such word one random bit) at the IMM
and round shapes (m = 8), with the IMM's words at m = 2 and m = 32, and
at two small shapes where the picks' fixed costs decide (``--shapes``
names some of them); for each share and solve, the dense layout forced,
the compact layout forced (one compaction at the list's size, its
8-byte count read, the picks) and the wrapper with the layout it chose.
Once the compact layout takes four times the dense one, larger shares
skip it.

``--axis handover``: the handover threshold's measurement.  Rows of the
supercritical shape ([8, 4096, 1024], each non-zero word one random bit)
whose residual after the first pick is a multiple of the handover's
room (``greedy_pick.list_room``: 0.25, 0.5, 1, 2 and 4 times it); for
each and each dense solve, the dense sweep forced to the end (``cap=0``)
and the solve with its handover forced after the first pick (``cap``
the residual counted there).

Every input checks that all the solves of it agree bit for bit and
prints a digest of the outputs: runs of two versions on the same inputs
must print the same digests.  Times are CUDA-event medians.  ``--src``
names the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so two versions can be compared on one machine in
one run: run them alternately (A, B, B, A).  Prints the card line, then
one JSON line per input and solver.  Exits non-zero without a CUDA
device.
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

# The supercritical configuration of chip_smoke.py (DENSE_FULL,
# DENSE_ROUND): SNAP com-Orkut's average degree, cut to n = 32,768.
SUPERCRITICAL_N, SUPERCRITICAL_DEG, SUPERCRITICAL_THETA = 32768, 76.3, 32768
SWEEP_SHARES = (1e-4, 1e-3, 3e-3, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5)
SWEEP_SHAPES = {"imm": (8, 32768, 1024), "round": (8, 32768, 4096),
                "imm m=2": (2, 131072, 1024), "imm m=32": (32, 8192, 1024),
                "small m=3": (3, 1000, 36), "small m=8": (8, 1024, 128)}
SWEEP_GIVE_UP = 4.0     # compact / dense time past which larger shares skip
MACHINE_SHAPES = ("imm", "round", "imm supercritical", "round supercritical")
HANDOVER_SHAPE = (8, 4096, 1024)
HANDOVER_ROOMS = (0.25, 0.5, 1.0, 2.0, 4.0)


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


def emit(**fields):
    print(json.dumps(fields), flush=True)


def query_axis(args, dev):
    from repro_torch.core import maxcover, prng, service
    from repro_torch.graphs import generators
    from repro_torch.kernels import build, greedy_pick, lazy_greedy, topk_gain
    from repro_torch.launch import serve

    gain_core = os.path.join(os.path.dirname(build.__file__), "csrc",
                             "gain_core.cuh")
    with open(gain_core, "rb") as f:
        version = hashlib.sha256(f.read()).hexdigest()[:12]
    build.build(("coin_pack", "rrr_expand", "greedy_pick", "lazy_greedy",
                 "topk_gain"))

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
        fused = maxcover.greedy_maxcover_batch(rows, exc, kk, solver="fused")
        fused = (fused.seeds, fused.rows, fused.covered, fused.gains)
        if any(not torch.equal(a, b) for a, b in zip(res, lazy)) or any(
                not torch.equal(a, b) for a, b in zip(res, fused)):
            raise AssertionError(f"{name}: resident, lazy and fused solves "
                                 "differ")
        cov0 = torch.zeros((bq, rows.shape[1]), dtype=torch.int32,
                           device=dev)
        picked = torch.zeros((bq, rows.shape[0]), dtype=torch.bool,
                             device=dev)
        listed = (exc >= 0) & (exc < rows.shape[0])     # ids past n pick none
        picked[torch.arange(bq, device=dev)[:, None].expand_as(exc)[listed],
               exc[listed].long()] = True
        pick = topk_gain.best_gain_index_batch(rows, cov0, picked)
        for solver, fn, outs in (
                ("greedy_pick_batch", lambda: greedy_pick.
                 greedy_maxcover_resident_batch(rows, kk, exc), res),
                ("lazy_greedy_batch", lambda: lazy_greedy.
                 greedy_maxcover_lazy_batch(rows, kk, exc), res),
                ("topk_gain_batch", lambda: topk_gain.best_gain_index_batch(
                    rows, cov0, picked), pick),
                ("fused solve", lambda: maxcover.greedy_maxcover_batch(
                    rows, exc, kk, solver="fused"), res)):
            emit(label=args.label, gain_core=version, input=name,
                 kernel=solver, B=bq, n=rows.shape[0], W=rows.shape[1],
                 k=1 if solver == "topk_gain_batch" else kk,
                 ms=median_ms(fn, args.reps), outputs=digest(outs),
                 tiles_swept=swept.tolist() if solver.startswith("lazy")
                 else None)
        del res, lazy, fused, pick


def machine_rows(seed: int, dev, wanted=MACHINE_SHAPES):
    """{name: rows int32 [m, n, W]} of the full-size runs' machine axis,
    those named in ``wanted``."""
    from repro_torch.core import greediris, prng, rrr
    from repro_torch.graphs import csr, generators

    shapes = {}
    for label, n, deg, imm_theta, round_theta in (
            ("", 262144, 4.0, 32768, 131072),
            (" supercritical", SUPERCRITICAL_N, SUPERCRITICAL_DEG,
             SUPERCRITICAL_THETA, SUPERCRITICAL_THETA)):
        if not {"imm" + label, "round" + label} & set(wanted):
            continue
        m = 8
        g = generators.erdos_renyi(n, deg, seed, device=dev)
        nbr, prob, wt = csr.padded_adjacency(g)
        fwd = csr.padded_forward_adjacency(g)
        # the IMM selector's local rows, as chip_smoke.py's
        # main_path_timings
        inc = rrr.sample_incidence(nbr, prob, wt, prng.key(seed).fold_in(1),
                                   theta=imm_theta, n=n, model="IC", fwd=fwd)
        perm = prng.key(seed).fold_in(0xC0FFEE).fold_in(1).permutation(
            n, device=dev)
        assign = perm[:(n // m) * m].reshape(m, n // m).long()
        shapes["imm" + label] = inc[assign].contiguous()
        del inc
        fn, _, _ = greediris.build_round(m=m, n=n, theta=round_theta, k=100,
                                         max_degree=0, model="IC",
                                         sampler="kernel", fwd=fwd)
        shapes["round" + label] = fn.sample_shuffle(nbr, prob, wt,
                                                    prng.key(seed))[0]
    return shapes


def solvers():
    """(name, wrapper, dense, compact) of the two machine-axis solves."""
    from repro_torch.kernels import greedy_pick, lazy_greedy
    return (("resident", greedy_pick.greedy_maxcover_resident,
             greedy_pick.greedy_dense, greedy_pick.greedy_compact),
            ("lazy", lazy_greedy.greedy_maxcover_lazy,
             lazy_greedy.lazy_dense, lazy_greedy.lazy_compact))


def handovers():
    """The dense picks up to the handover of the two machine-axis solves:
    ``fn(rows, k, ex, cap) -> (state, *lazy state)``."""
    from repro_torch.kernels import greedy_pick, lazy_greedy
    return (lambda *a: (greedy_pick.dense_picks(*a),),
            lazy_greedy.lazy_dense_picks)


def handover_split(rows, k, ex, upto, picks, reps: int) -> dict:
    """The parts of a dense solve with its handover: the dense launch up
    to the handover with its tally's read (``dense_picks``), the
    residual's compaction with its count's read (``lists``) and the
    compact picks from the handover state (``compact_from``; each run on
    a copy of the state, the copy inside the timing)."""
    from repro_torch.kernels import greedy_pick
    cap = greedy_pick.list_room(*rows.shape)
    state, *lazy = upto(rows, k, ex, cap)
    lists = greedy_pick.residual_lists(rows, state, cap)

    def from_copy():
        st = state._replace(out=tuple(o.clone() for o in state.out),
                            taken=state.taken.clone())
        return picks(rows, k, ex, lists, st, *(t.clone() for t in lazy))
    return dict(
        dense_picks=median_ms(lambda: upto(rows, k, ex, cap), reps),
        lists=median_ms(lambda: greedy_pick.residual_lists(rows, state, cap),
                        reps),
        compact_from=median_ms(from_copy, reps))


def exact_list(rows, count: int):
    """The list of ``rows`` built once at its size ``count`` (the count
    read back): the compact layout forced."""
    from repro_torch.kernels import greedy_pick
    lists = greedy_pick.compact_rows(rows, max(count, 1))
    return lists._replace(entries=lists.entries[:lists.nonzero_words])


def machine_axis(args, dev):
    from repro_torch.kernels import greedy_pick, lazy_greedy

    k = 100
    compact = hasattr(greedy_pick, "row_lists")
    handover = hasattr(greedy_pick, "list_room")
    wanted = [x for x in args.shapes or MACHINE_SHAPES if x in MACHINE_SHAPES]
    for label, rows in machine_rows(args.seed, dev, wanted).items():
        if label not in wanted:
            continue
        m = rows.shape[0]
        ex = greedy_pick.excluded_ids(None, m, dev)
        stats = {}
        res = greedy_pick.greedy_maxcover_resident(rows, k, ex)
        lazy = lazy_greedy.greedy_maxcover_lazy(rows, k, ex, stats=stats)
        if digest(res) != digest(lazy[:4]):
            raise AssertionError(f"{label}: resident != lazy")
        out = dict(label=args.label, shape=label, rows=list(rows.shape),
                   digest=digest(res), tiles_swept=lazy[4].tolist(),
                   resident_ms=median_ms(
                       lambda: greedy_pick.greedy_maxcover_resident(
                           rows, k, ex), args.reps),
                   lazy_ms=median_ms(lambda: lazy_greedy.greedy_maxcover_lazy(
                       rows, k, ex), args.reps), **stats)
        if compact:
            count = greedy_pick.compact_rows(rows, 1).nonzero_words
            lists = exact_list(rows, count)
            out["compaction_ms"] = median_ms(
                lambda: greedy_pick.compact_rows_launch(rows, max(count, 1)),
                args.reps)
            for name, _, dense, picks in solvers():
                forced = {"dense": lambda: dense(rows, k, ex),
                          "compact": lambda: picks(rows, k, ex,
                                                   exact_list(rows, count))}
                for layout, fn in forced.items():
                    if digest(fn()[:4]) != out["digest"]:
                        raise AssertionError(f"{label}: {name} {layout} "
                                             "differs")
                    out[f"{name}_{layout}_ms"] = median_ms(fn, args.reps)
                out[f"{name}_picks_ms"] = median_ms(
                    lambda: picks(rows, k, ex, lists), args.reps)
        if handover:
            for (name, _, dense, picks), upto in zip(solvers(), handovers()):
                full, handed = {}, {}
                dense(rows, k, ex, cap=0, stats=full)
                if digest(dense(rows, k, ex, stats=handed)[:4]) != out[
                        "digest"]:
                    raise AssertionError(f"{label}: {name} dense differs")
                out[f"{name}_full_sweep_ms"] = median_ms(
                    lambda: dense(rows, k, ex, cap=0), args.reps)
                out[f"{name}_handover_pick"] = handed["handover_pick"]
                out[f"{name}_residual"] = full["residual"][:8]
                out[f"{name}_spent_pick"] = full["spent_pick"]
                out.update({f"{name}_{part}_ms": ms for part, ms in
                            handover_split(rows, k, ex, upto, picks,
                                           args.reps).items()})
        emit(**out)
        del res, lazy


def synthetic_rows(shape, share: float, seed: int, dev):
    """int32 rows whose words are non-zero with probability ``share``,
    each such word one random bit (the IC incidence words hold one
    sample member or a few), made on the card machine by machine."""
    m, n, w = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.empty(shape, dtype=torch.int32, device=dev)
    for j in range(m):
        keep = torch.rand((n, w), generator=gen, device=dev) < share
        bit = torch.randint(0, 32, (n, w), generator=gen, device=dev,
                            dtype=torch.int32)
        rows[j] = torch.where(keep, torch.ones_like(bit) << bit, 0)
        del keep, bit
    return rows


def sweep_axis(args, dev):
    from repro_torch.kernels import greedy_pick

    k = 100
    for label in [x for x in args.shapes or SWEEP_SHAPES
                  if x in SWEEP_SHAPES]:
        shape = SWEEP_SHAPES[label]
        gave_up = set()
        for share in SWEEP_SHARES:
            rows = synthetic_rows(shape, share, args.seed, dev)
            ex = greedy_pick.excluded_ids(None, shape[0], dev)
            count = greedy_pick.compact_rows(rows, 1).nonzero_words
            words = rows.numel()
            out = dict(label=args.label, shape=label, rows=list(shape),
                       share=share, nonzero_words=count,
                       list_bytes=8 * count,
                       compaction_ms=median_ms(
                           lambda: greedy_pick.compact_rows_launch(
                               rows, count), args.reps),
                       count_ms=median_ms(
                           lambda: greedy_pick.compact_rows_launch(
                               rows, max(words // 128, 1 << 16)), args.reps))
            want = None
            for name, wrapper, dense, picks in solvers():
                stats = {}
                got = wrapper(rows, k, ex, stats=stats)
                want = digest(got[:4]) if want is None else want
                out[f"{name}_layout"] = stats["layout"]
                out[f"{name}_wrapper_ms"] = median_ms(
                    lambda: wrapper(rows, k, ex), args.reps)
                forced = {"dense": lambda: dense(rows, k, ex)}
                if name not in gave_up:
                    forced["compact"] = lambda: picks(rows, k, ex,
                                                      exact_list(rows, count))
                for layout, fn in forced.items():
                    if digest(fn()[:4]) != want:
                        raise AssertionError(f"{label} {share}: {name} "
                                             f"{layout} differs")
                    out[f"{name}_{layout}_ms"] = median_ms(fn, args.reps)
                if (out.get(f"{name}_compact_ms", 0.0)
                        > SWEEP_GIVE_UP * out[f"{name}_dense_ms"]):
                    gave_up.add(name)
            out["digest"] = want
            emit(**out)
            del rows
            torch.cuda.empty_cache()


def handover_axis(args, dev):
    from repro_torch.kernels import greedy_pick

    k = 100
    m, n, w = HANDOVER_SHAPE
    room = greedy_pick.list_room(m, n, w)
    ex = greedy_pick.excluded_ids(None, m, dev)
    for rooms in HANDOVER_ROOMS:
        rows = synthetic_rows(HANDOVER_SHAPE, rooms * room / (m * n * w),
                              args.seed, dev)
        out = dict(label=args.label, shape=list(HANDOVER_SHAPE),
                   rooms=rooms, room=room)
        want = None
        for name, _, dense, _ in solvers():
            full, handed = {}, {}
            got = digest(dense(rows, k, ex, cap=0, stats=full)[:4])
            cap = full["residual"][0]
            want = got if want is None else want
            if digest(dense(rows, k, ex, cap=cap, stats=handed)[:4]) != got \
                    or got != want or handed["handover_pick"] != 1:
                raise AssertionError(f"{rooms}: {name} differs or did not "
                                     f"hand over after pick 0 {handed}")
            out.update({f"{name}_residual": cap,
                        f"{name}_full_sweep_ms": median_ms(
                            lambda: dense(rows, k, ex, cap=0), args.reps),
                        f"{name}_handover_ms": median_ms(
                            lambda: dense(rows, k, ex, cap=cap), args.reps)})
        out["digest"] = want
        emit(**out)
        del rows
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--axis", default="query",
                    choices=("query", "machine", "sweep", "handover"))
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--shapes", nargs="*",
                    choices=tuple(SWEEP_SHAPES) + MACHINE_SHAPES,
                    help="the sweep's or the machine axis's shapes "
                    "(default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_solves: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    {"query": query_axis, "machine": machine_axis,
     "sweep": sweep_axis, "handover": handover_axis}[args.axis](args, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
