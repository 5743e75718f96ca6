#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version on the card (exact
equality: every output is integer words or ids, so the tolerance is
zero), checks the kernel paths against the plain paths end to end at a
small size, drives the port's main path at full size through the
driver a user calls, then times every kernel at the shapes that run
gave it.  Prints JSON lines; the line before the last lists the
kernels, the last line is the device summary.  Exits non-zero without
a CUDA device or on any failure.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import bitset, imm, prng, rrr  # noqa: E402
from repro_torch.core import cascade, maxcover, streaming  # noqa: E402
from repro_torch.graphs import csr, generators  # noqa: E402
from repro_torch.kernels import (build, bucket_insert, coins,  # noqa: E402
                                 greedy_pick, ops, rrr_expand)
from repro_torch.launch import im_driver  # noqa: E402

# The slice's command: SNAP com-DBLP scale (317k vertices, 1.05M edges),
# edge probabilities U[0, 0.1] (paper §4.1), k=100 (B=63 buckets).
FULL = ["--graph", "er", "--n", "262144", "--avg-deg", "4", "--k", "100",
        "--selector", "greediris", "--machines", "8", "--sampler", "kernel",
        "--gather", "resident", "--solver", "resident", "--use-kernel",
        "--max-theta", "32768", "--eval-engine", "kernel", "--eval-sims",
        "64"]

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak bandwidth
# INT32 ALU peak: 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock (NVIDIA
# publishes no INT32 rate for H100; this follows the SM's lane count).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_COIN = 80              # threefry: 20 x (add, rotate, xor) + keys
                               # + float conversion and compare

SOURCES = {
    "rrr_expand_resident": (
        "src/repro_torch/kernels/csrc/rrr_expand.cu",
        "src/repro/kernels/rrr_expand.py:351"),
    "rrr_expand_streamed": (
        "src/repro_torch/kernels/csrc/rrr_expand.cu",
        "src/repro/kernels/rrr_expand.py:271"),
    "coin_pack": (
        "src/repro_torch/kernels/csrc/coin_pack.cu",
        "src/repro/core/rrr.py:309 (XLA draw, no TPU kernel)"),
    "greedy_pick": (
        "src/repro_torch/kernels/csrc/greedy_pick.cu",
        "src/repro/kernels/greedy_pick.py:197"),
    "bucket_insert": (
        "src/repro_torch/kernels/csrc/bucket_insert.cu",
        "src/repro/kernels/bucket_insert.py:214"),
}


def emit(**fields):
    print(json.dumps(fields), flush=True)


def max_err(got, want) -> int:
    """Largest |difference| over paired outputs; 0 means bit-equal."""
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel() and not torch.equal(a, b):
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def require_equal(name, got, want, **shape):
    err = max_err(got, want)
    emit(phase="parity", kernel=name, max_abs_err=err, **shape)
    if err:
        raise AssertionError(f"{name}: kernel != plain version ({shape})")
    return err


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


def rand_words(gen, *shape, dev):
    return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                         dtype=torch.int32, device="cpu").to(dev)


# ---------------------------------------------------------------- phase 3

def parity_small(dev) -> dict:
    """Each kernel against its plain version at unaligned shapes with
    pads, ties, exclusions and full buckets."""
    gen = torch.Generator().manual_seed(0)
    errs = {}
    n, df, w = 1001, 7, 5
    frontier = rand_words(gen, n, w, dev=dev) & rand_words(gen, n, w, dev=dev)
    visited = frontier | rand_words(gen, n, w, dev=dev)
    nbr = torch.randint(0, n, (n, df), generator=gen, dtype=torch.int32
                        ).to(dev)
    rows = 2 * n + 3
    plane = rand_words(gen, rows, w, dev=dev)
    gidx = torch.randint(0, rows + 1, (n, df), generator=gen,
                         dtype=torch.int32).to(dev)      # rows = zero row
    errs["rrr_expand_resident"] = require_equal(
        "rrr_expand_resident",
        rrr_expand.rrr_expand_step_resident(frontier, visited, nbr, gidx,
                                            plane),
        rrr_expand.expand_step_resident_plain(frontier, visited, nbr, gidx,
                                              plane), n=n, df=df, W=w)
    gmask = rand_words(gen, n, df, w, dev=dev)
    gmask[:, -1] = 0                                     # invalid slot
    errs["rrr_expand_streamed"] = require_equal(
        "rrr_expand_streamed",
        rrr_expand.rrr_expand_step(frontier, visited, nbr, gmask),
        rrr_expand.expand_step_plain(frontier, visited, nbr, gmask),
        n=n, df=df, W=w)

    key = prng.key(7).fold_in(3)
    err = 0
    for n_c, chunk, n_chunks, w_c, dens in ((301, 3, 2, 3, 3),
                                            (262144, 16, 1, 40, 12)):
        # the second shape's flat draw index passes 2**32
        keys = [key.fold_in(c) for c in range(n_chunks)]
        prob = torch.rand((n_c, chunk * n_chunks), generator=gen) * 0.6
        prob[:, -1] = 0.0
        f = rand_words(gen, n_c, w_c, dev=dev)
        for _ in range(dens):
            f &= rand_words(gen, n_c, w_c, dev=dev)
        prob = prob.to(dev)
        err = max(err, require_equal(
            "coin_pack", [coins.coin_plane(keys, prob, f, chunk)],
            [coins.coin_plane_plain(keys, prob, f, chunk)], n=n_c,
            d_pad=chunk * n_chunks, W=w_c,
            max_flat_index=(32 * w_c * n_c) * chunk))
    errs["coin_pack"] = err

    err = 0
    for m, n_g, w_g, k, ex in ((3, 1001, 5, 12, [[1, -1, 5000], [0, 2, 3],
                                                 [-1, -1, -1]]),
                               (2, 10, 2, 15, [[4], [-1]])):
        rows_g = rand_words(gen, m, n_g, w_g, dev=dev)
        for _ in range(3):
            rows_g &= rand_words(gen, m, n_g, w_g, dev=dev)
        rows_g[:, 7 % n_g] = rows_g[:, 2 % n_g]           # ties
        exc = torch.tensor(ex, dtype=torch.int32, device=dev)
        err = max(err, require_equal(
            "greedy_pick", greedy_pick.greedy_maxcover_resident(rows_g, k, exc),
            greedy_pick.greedy_plain(rows_g, k, exc), m=m, n=n_g, W=w_g, k=k))
    errs["greedy_pick"] = err

    b, c, w_b, k = 63, 301, 7, 4
    ids = torch.randint(-1, 5000, (c,), generator=gen, dtype=torch.int32)
    args = (ids.to(dev), rand_words(gen, c, w_b, dev=dev)
            & rand_words(gen, c, w_b, dev=dev),
            rand_words(gen, b, w_b, dev=dev) & rand_words(gen, b, w_b, dev=dev),
            torch.randint(0, k + 1, (b,), generator=gen,
                          dtype=torch.int32).to(dev),
            torch.full((b, k), -1, dtype=torch.int32, device=dev),
            (torch.rand(b, generator=gen) * 40).to(dev))
    errs["bucket_insert"] = require_equal(
        "bucket_insert", bucket_insert.bucket_insert_chunk(*args),
        bucket_insert.bucket_insert_plain(*args), B=b, C=c, W=w_b, k=k)
    torch.cuda.synchronize()
    return errs


# ---------------------------------------------------------------- phase 4

def paths_agree(dev):
    """Kernel paths against plain paths, and the card against the CPU:
    identical seeds, theta, coverage and spread."""
    for model in ("IC", "LT"):
        results = {}
        for name, device, sampler, solver, use_kernel, engine in (
                ("plain-cpu", "cpu", "packed", "scan", False, "packed"),
                ("plain-gpu", dev, "packed", "scan", False, "packed"),
                ("kernel-gpu", dev, "kernel", "resident", True, "kernel")):
            g = generators.erdos_renyi(3000, 4.0, seed=5, device=device)
            key = prng.key(5)
            sel = imm.make_randgreedi_selector(4, "streaming", 0.077,
                                               use_kernel=use_kernel,
                                               solver=solver)
            res = imm.imm(g, 10, 0.13, key, model=model, selector=sel,
                          max_theta=2048, sampler=sampler)
            spreads = [float(cascade.spread(
                g, torch.from_numpy(res.seeds), key.fold_in(99),
                model=model, num_sims=64, engine=engine, gather=gather))
                for gather in ("auto", "resident")]
            results[name] = (res.seeds.tolist(), res.theta,
                             res.coverage_fraction, spreads)
        emit(phase="paths", model=model, **{k: dict(
            seeds=v[0], theta=v[1], coverage_fraction=v[2], spreads=v[3])
            for k, v in results.items()})
        if len({json.dumps(v) for v in results.values()}) != 1:
            raise AssertionError(f"{model}: paths disagree")


# ---------------------------------------------------------------- phase 5

def full_run():
    ops.reset_launches()
    out = im_driver.run(FULL)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    seeds = out["seeds"]
    emit(phase="full", theta=out["theta"], rounds=out["rounds"],
         coverage_fraction=out["coverage_fraction"], spread=out["spread"],
         n=out["n"], edges=out["edges"], seconds=dict(
             graph=out["graph_s"], sample=out["sample_s"],
             select=out["select_s"], spread=out["spread_s"]),
         bfs_steps=out["bfs_steps"], peak_bytes=out["peak_bytes"],
         launches=launches)
    real = seeds[seeds >= 0]
    if not (len(real) == 100 and len(set(real.tolist())) == 100
            and real.max() < out["n"]):
        raise AssertionError(f"bad seed set {seeds}")
    if not (0.0 < out["coverage_fraction"] <= 1.0
            and np.isfinite(out["spread"]) and out["spread"] >= len(real)):
        raise AssertionError("coverage or spread out of range")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    return launches, seeds


# ---------------------------------------------------------------- phase 6

def timed(name, kernel_fn, plain_fn, reps, plain_reps, bytes_, ops_=0.0):
    """Kernel vs plain on the same main-path inputs: equality, medians,
    and the bound (the larger of bytes over HBM rate and integer ops
    over the INT32 rate)."""
    err = max_err(kernel_fn(), plain_fn())
    if err:
        raise AssertionError(f"{name}: kernel != plain at main-path shapes")
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / INT32_OPS_PER_S * 1e3
    row = dict(name=name, route="cuda", source=SOURCES[name][0],
               replaces=SOURCES[name][1], max_abs_err=err,
               ms=median_ms(kernel_fn, reps),
               plain_ms=median_ms(plain_fn, plain_reps),
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=None)
    torch.cuda.empty_cache()
    emit(phase="timing", bytes=bytes_, int_ops=ops_, **row)
    return row


def main_path_timings(dev, final_seeds) -> dict:
    """Every kernel at the shapes the full run gives it: the first BFS
    step of a 32768-sample draw, the local solves and the receiver of
    the selector over that incidence, and the first cascade step."""
    args = im_driver.parser().parse_args(FULL)
    n, theta, k, m = args.n, args.max_theta, args.k, args.machines
    g = generators.erdos_renyi(n, args.avg_deg, args.seed, device=dev)
    nbr, prob, wt = csr.padded_adjacency(g)
    fwd = csr.padded_forward_adjacency(g)
    key = prng.key(args.seed).fold_in(1)
    t = rrr._Tables(nbr, prob, wt, *fwd, model="IC",
                    coin_chunk=args.coin_chunk)
    kr, kb = key.split()
    roots = kr.randint((theta,), 0, n, device=dev)
    frontier = rrr.packed_roots(roots, n)
    visited = frontier.clone()
    sub = kb.split()[1]
    keys = [sub.fold_in(c) for c in range(t.n_chunks)]
    W = frontier.shape[1]
    rows_out = {}

    fb = 4 * frontier.numel()
    live_bits = bitset.popcount(frontier).sum(1, dtype=torch.int64)
    coins_needed = int((live_bits * (t.prob_p > 0).sum(1)).sum())
    rows_out["coin_pack"] = timed(
        "coin_pack", lambda: [coins.coin_plane(keys, t.prob_p, frontier,
                                               t.chunk)],
        lambda: [coins.coin_plane_plain(keys, t.prob_p, frontier, t.chunk)],
        10, 3, bytes_=fb + 4 * t.prob_p.numel() + 4 * n * t.d_pad * W,
        ops_=OPS_PER_COIN * coins_needed)

    plane = coins.coin_plane(keys, t.prob_p, frontier, t.chunk
                             ).reshape(n * t.d_pad, W)
    in_deg = (nbr >= 0).sum(1)
    plane_words = int(((frontier != 0).sum(1) * in_deg).sum())
    rows_out["rrr_expand_resident"] = timed(
        "rrr_expand_resident",
        lambda: rrr_expand.rrr_expand_step_resident(
            frontier, visited, t.nbr_c, t.gidx, plane),
        lambda: rrr_expand.expand_step_resident_plain(
            frontier, visited, t.nbr_c, t.gidx, plane),
        10, 3, bytes_=4 * fb + 8 * t.nbr_c.numel() + 4 * plane_words)
    del plane, t

    incidence = rrr.sample_incidence(nbr, prob, wt, key, theta=theta, n=n,
                                     model="IC", fwd=fwd)
    perm = prng.key(args.seed).fold_in(0xC0FFEE).fold_in(1).permutation(
        n, device=dev)
    assign = perm[:(n // m) * m].reshape(m, n // m).long()
    local_rows = incidence[assign].contiguous()
    del incidence
    ex = greedy_pick.excluded_ids(None, m, dev)
    rows_out["greedy_pick"] = timed(
        "greedy_pick",
        lambda: greedy_pick.greedy_maxcover_resident(local_rows, k, ex),
        lambda: greedy_pick.greedy_plain(local_rows, k, ex), 5, 1,
        bytes_=4 * (local_rows.numel() + m * k * W + m * W + 2 * m * k))
    local = maxcover.greedy_maxcover(local_rows, k, solver="resident")
    del local_rows
    ids = torch.where(local.seeds >= 0, torch.gather(
        assign, 1, local.seeds.clamp(min=0).long()).to(torch.int32), -1
    ).reshape(-1).contiguous()
    sent = local.rows.reshape(-1, W).contiguous()
    st = streaming.init_state(k, args.delta, float(local.gains[:, 0].max()),
                              W, device=dev)
    b = st.covers.shape[0]
    rows_out["bucket_insert"] = timed(
        "bucket_insert",
        lambda: bucket_insert.bucket_insert_chunk(ids, sent, *st),
        lambda: bucket_insert.bucket_insert_plain(ids, sent, *st), 10, 3,
        bytes_=4 * (ids.numel() * (W + 1) + 2 * b * W + 2 * b
                    + 2 * b * k + b))
    del sent, local

    sims = args.eval_sims
    chunk, n_chunks, d_pad = rrr._coin_chunks(nbr.shape[1], args.coin_chunk)
    tbl = torch.nn.functional.pad(torch.where(nbr >= 0, nbr, 0),
                                  (0, d_pad - nbr.shape[1])).contiguous()
    live = cascade._live_mask(nbr, prob, wt, prng.key(args.seed).fold_in(99),
                              model="IC", num_sims=sims, chunk=chunk,
                              n_chunks=n_chunks, d_pad=d_pad)
    smask = cascade.seeds_to_mask(n, final_seeds, device=dev)
    act = torch.where(smask[:, None],
                      cascade._lane_words(sims, dev)[None], 0
                      ).to(torch.int32)
    gm_words = int(sum(int((act[tbl[:, s].long()] != 0).sum())
                       for s in range(d_pad)))
    rows_out["rrr_expand_streamed"] = timed(
        "rrr_expand_streamed",
        lambda: rrr_expand.rrr_expand_step(act, act, tbl, live),
        lambda: rrr_expand.expand_step_plain(act, act, tbl, live), 10, 3,
        bytes_=4 * (4 * act.numel() + tbl.numel() + gm_words))
    return rows_out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stop-after", choices=("build", "parity", "paths",
                                             "full"),
                    help="end early after this phase (no result lines)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    emit(phase="env", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc[-1] if nvcc else None)

    build_s = build.build()
    regs = [ln.strip() for name in build.LIBS
            for ln in build.build_log(name).splitlines()
            if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=build_s, ptxas=regs)
    if args.stop_after == "build":
        return 0

    errs = parity_small(dev)
    if args.stop_after == "parity":
        return 0
    paths_agree(dev)
    if args.stop_after == "paths":
        return 0
    launches, seeds = full_run()
    if args.stop_after == "full":
        return 0
    rows = main_path_timings(dev, torch.from_numpy(seeds))
    kernels = []
    for name in ops.KERNELS:
        row = rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], errs[name])
        row["launches"] = launches[name]
        kernels.append(row)
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
