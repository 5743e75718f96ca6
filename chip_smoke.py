#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
runs the launch and footprint checker on the card (phase ``contracts``:
every contract of ``repro_torch.analysis.contracts`` and the port's AST
lint, each device function's static shared memory, registers and local
memory, and the shared-memory model at the full-size shapes), holds
each kernel against its plain PyTorch version on the card (exact
equality: every output is integer words or ids, so the tolerance is
zero), checks the kernel paths against the plain paths end to end at a
small size (the IMM loop, the fixed-theta GreediRIS round and the
Ripples round over every solver, receiver, schedule and shuffle, the
serving replay over every solver, OPIM, and the spread under IC, LT and
WC over every engine and gather, against the CPU's map and packed
engines), drives every path at full
size through the entry points a user calls (the IMM loop with the
GreediRIS selector and the spread's cross-check over the map, packed
and kernel engines, phase ``full``; the same IMM on the sampler's
streamed layout, whose steps draw the coin plane through coin_pack and
expand through rrr_expand_streamed, phase ``streamed``, which must give
``full``'s results; the weighted-cascade spread of its seeds over every
route, phase ``wc``; the fixed-theta round with the
lazy and the fused senders, and under injected faults through the
resilient round (survivors merge, plain twin, all machines lost), phase
``faulted``; the Ripples round; the serving replay with the resident,
the fused and the lazy senders; every one but ``streamed`` samples IC
through rrr_expand_ic, a push over the frontier's live words that draws
the coins in the step and builds no coin plane, and solves its machine
axis on the compact layout, the list of the rows' non-zero words; every
kernel-engine spread steps through
cascade_ic, which draws the live edges in the step and builds no
live-edge plane), drives the same IMM under LT (sampling through
rrr_expand_lt and spreading through cascade_lt, which draw each live
in-edge in the step and build no selection or live-edge plane; its
results held to those recorded before these kernels), drives IMM and
the lazy round on a supercritical
configuration, whose nearly dense rows take the dense layout, then times
every kernel at the shapes those runs gave it (the receivers also at the
supercritical shapes, with the passes, accepts and rows read of their
grouped settlement beside each time), splits the spread into
its parts (phase ``spread_split``) and ranks the kernels by the time each
loses over those runs (phase ``order``).  Phase ``lm``, after the serving
replay, drives the LM scaffold (``tools/time_lm.py``): all ten SMOKE
architectures on the card against the CPU, gemma-7b's and
recurrentgemma-2b's full configs through prefill and 16 decode steps
against their forwards, deepseek-v3 at full width cut to one dense and
one MoE layer through prefill and 16 absorbed MLA decode steps against
its forward (with its MTP head), gemma-7b and recurrentgemma-2b at full
width cut in depth through 3 train steps (gemma's with a microbatched
gradient), and mamba2-370m's and seamless-m4t-large-v2's full configs
through ``launch.train`` with ``--coreset`` (the fused receiver) and a
checkpoint resumed bit for bit.  Prints JSON lines; the line before the last
lists the kernels, the last line is the device summary.  Exits non-zero
without a CUDA device or on any failure.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import bitset, greediris, imm, prng, rrr  # noqa: E402
from repro_torch.core import (cascade, maxcover, randgreedi,  # noqa: E402
                              streaming)
from repro_torch.graphs import csr, generators  # noqa: E402
from repro_torch.core import service  # noqa: E402
from repro_torch.analysis import check, contracts  # noqa: E402
from repro_torch.kernels import (build, bucket, bucket_insert,  # noqa: E402
                                 coins, coverage, greedy_pick, lazy_greedy,
                                 ops, rrr_expand, smem_budget, topk_gain)
from repro_torch.launch import im_driver, serve  # noqa: E402
from tools.time_sampler import SamplerClock  # noqa: E402
from tools.time_receiver import (imm_chunk, regime_inputs,  # noqa: E402
                                 round_stream, summary)
from tools.time_spread import split_spread  # noqa: E402
from tools.time_lm import lm_phase  # noqa: E402
from tools.timing import median_ms  # noqa: E402

# The slice's command: SNAP com-DBLP scale (317k vertices, 1.05M edges),
# edge probabilities U[0, 0.1] (paper §4.1), k=100 (B=63 buckets).
FULL = ["--graph", "er", "--n", "262144", "--avg-deg", "4", "--k", "100",
        "--selector", "greediris", "--machines", "8", "--sampler", "kernel",
        "--gather", "resident", "--solver", "resident", "--use-kernel",
        "--max-theta", "32768", "--eval-engine", "kernel", "--eval-sims",
        "64"]
# Slice 2: the fixed-theta distributed round at the same scale, m = 8
# machines of theta/m = 16,384 samples (W_global = 4096 words).
ROUND = ["--graph", "er", "--n", "262144", "--avg-deg", "4", "--k", "100",
         "--machines", "8", "--theta", "131072", "--selector", "greediris",
         "--sampler", "kernel", "--solver", "lazy", "--use-kernel",
         "--chunk-size", "auto", "--eval-engine", "kernel", "--eval-sims",
         "64"]
# Slice 3: the online influence service at the same scale — the pool
# grows 32,768 -> 65,536 -> 131,072 samples per half (W = 4096 words at
# the end), 32 queries in batches of 8 with k up to 100, refreshed after
# every batch so tickets drain on older generations; --check replays
# every query through the sequential path.
SERVE = ["--graph", "er", "--n", "262144", "--avg-deg", "4", "--model", "IC",
         "--sampler", "kernel", "--theta0", "32768", "--max-theta", "131072",
         "--slab", "4096", "--queries", "32", "--batch", "8", "--k-max",
         "100", "--refresh-every", "1", "--check"]
SERVE_PEAK_LIMIT = 40e9
# The slice's IMM under the paper's other diffusion model, Linear
# Threshold: the same graph, k, m and theta cut.
LT_FULL = FULL + ["--model", "LT"]
# Its results as first recorded on the card, through the selection and
# live-edge planes (PERF.md §6): the kernel route must give them bit for
# bit (seeds by the sha256 of their JSON list).
LT_RECORDED = dict(theta=32768, rounds=1, coverage_fraction=0.058837890625,
                   spread=16418.515625, bfs_steps=32,
                   seeds_sha256="f49486f38e8a4694")
# The LT run's kernels: its sampler's push and its spread's step.
LT_RUN = ("rrr_expand_lt", "cascade_lt")
# Slice 4, the paths that check a result: the slice-1 IMM run with the
# spread's cross-check (--eval-spread: the map, packed and kernel
# engines on its seeds, one value required) ...
FULL_CHECKED = FULL + ["--eval-spread"]
# The sampler's other layout at full size: FULL with --gather streamed,
# whose IC steps draw the coin plane (coin_pack, 17.2 GB at the first
# step) and expand through the gathered mask (rrr_expand_streamed).
# Every gather gives the same bits, so its results must be FULL's.
STREAMED = FULL + ["--gather", "streamed"]
STREAMED_RUN = ("coin_pack", "rrr_expand_streamed")
# Its sampling seconds and peak bytes as predicted before the plane
# step's redesign (PERF.md, PR 23): recorded beside the run's, not gated.
STREAMED_PREDICTED = dict(sample_s=(0.10, 0.16), peak_bytes=35.6e9)
# ... the weighted cascade (p(u -> v) = the normalized LT weight, ~1/d_in)
# on FULL's graph and the FULL run's seeds, over every route of the
# spread: (engine, gather) ...
WC_ROUTES = (("kernel", "auto"), ("kernel", "resident"),
             ("kernel", "streamed"), ("packed", "auto"), ("map", "auto"))
# ... and the round of ROUND under injected faults (runtime.faults):
# machine 3 dropped, machine 5's gains poisoned, machine 2 a straggler
# and the first merge raising (retried): the survivors merge.
FAULTS = ["--faults", "local.greedy:drop:3", "--faults",
          "local.greedy:nan:5", "--faults", "local.greedy:delay:2:0.05",
          "--faults", "receiver.insert:raise:0"]
FAULTED = ROUND + FAULTS
FAULT_SURVIVORS = (0, 1, 2, 4, 6, 7)
ALL_LOST = [a for j in range(8) for a in ("--faults",
                                          f"local.greedy:drop:{j}")]


def at_scale(argv, **flags):
    """``argv`` with the values of some flags replaced (``avg_deg`` for
    ``--avg-deg``)."""
    argv = list(argv)
    for flag, value in flags.items():
        argv[argv.index("--" + flag.replace("_", "-")) + 1] = str(value)
    return argv


# The supercritical configuration: the same edge probabilities U[0, 0.1]
# at SNAP com-Orkut's average degree (3,072,441 vertices, 117,185,083
# edges: 76.3 neighbours a vertex), cut to n = 32,768 vertices (2.5M
# edges).  A vertex expects 3.8 live in-edges, so most cascades reach
# most of the graph and nearly every incidence word is non-zero: the
# machine-axis solves take the dense layout.  IMM as FULL (theta up to
# 32,768) and the round as ROUND at theta = 32,768 (W_global = 1024),
# each at k = 100.
DENSE_FULL = at_scale(FULL, n=32768, avg_deg=76.3)
DENSE_ROUND = at_scale(ROUND, n=32768, avg_deg=76.3, theta=32768)
# Their results as recorded on the card before the dense sweeps stopped
# at exhausted gains and handed over (PERF.md §5): every later solve
# must give them bit for bit (seeds by the sha256 of their JSON list).
DENSE_RECORDED = {
    "imm supercritical": dict(coverage_fraction=0.979522705078125,
                              spread=31978.5625,
                              seeds_sha256="0d14bf751ffa3a95"),
    "round supercritical": dict(coverage_fraction=0.97833251953125,
                                spread=31978.984375,
                                seeds_sha256="2c0963a132c27e05")}
# The kernels of each full-size path and the run that must launch them.
# Every full-size run samples IC on the resident layout: the fused
# rrr_expand_ic, and no coin plane (coin_pack) at all; its machine-axis
# solve takes the compact layout (compact_rows, then the picks over the
# list), never the dense sweep; and its spread steps through cascade_ic,
# with no live-edge plane and no plane kernel.
SLICE1 = ("rrr_expand_ic", "cascade_ic", "compact_rows",
          "greedy_pick_compact", "bucket_insert")
ROUND_RUN = {"lazy_greedy_compact": "round lazy",
             "bucket_insert_stream": "round lazy",
             "topk_gain": "round fused", "coverage": "ripples"}
# The machine axis's dense sweeps, which the supercritical runs take (the
# layout rule, greedy_pick.compact_pays), and the run that launches each.
DENSE_RUN = {"greedy_pick": "imm supercritical",
             "lazy_greedy": "round supercritical"}
# The receivers and the supercritical run whose launches count for each
# at the supercritical shape (phase `order`).
RECEIVER_RUN = {"bucket_insert": "imm supercritical",
                "bucket_insert_stream": "round supercritical"}
SERVE_RUN = {"greedy_pick_batch": "serve resident",
             "lazy_greedy_batch": "serve lazy",
             "topk_gain_batch": "serve fused"}
# The plane kernel that only the WC spread's plane route launches at full
# size (phase `wc`, --gather resident, a launch a step).
PLANE_RUN = {"rrr_expand_resident": "wc resident"}
# The full-size runs, and the shape of rrr_expand_ic's timing each takes
# its time from (phase `order`).
FULL_RUNS = {"imm": "imm", "imm streamed": "imm", "lt": "lt",
             "round lazy": "round", "round fused": "round",
             "ripples": "round", "serve resident": "serve",
             "serve fused": "serve", "serve lazy": "serve", "wc": "wc",
             "wc resident": "wc", "wc streamed": "wc",
             "faulted lazy": "round"}

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak bandwidth
# INT32 ALU peak: 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock (NVIDIA
# publishes no INT32 rate for H100; this follows the SM's lane count).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit population count: 16 results per clock per SM at compute
# capability 9.0 (CUDA C++ Programming Guide, the arithmetic
# instructions' throughput table), 132 SMs x 16 x 1.98 GHz boost clock.
# The bounds leave the popcount pipe out: a zero gain word needs no
# popcount, and a carry-save (Harley-Seal) tree counts 16 non-zero ones
# with 5, which at 16 a clock take less time than the words' two INT32
# ops at 64 a clock.  It times the reports' one-popcount-a-word counts.
POPC_PER_S = 132 * 16 * 1.98e9
GAIN_OPS_PER_WORD = 1          # and-not: a zero gain word needs no more
GAIN_OPS_PER_NONZERO_WORD = 2  # popcount, add
OPS_PER_COIN = 80              # threefry: 20 x (add, rotate, xor) + keys
                               # + float conversion and compare

SOURCES = {
    "rrr_expand_resident": (
        "src/repro_torch/kernels/csrc/rrr_expand.cu",
        "src/repro/kernels/rrr_expand.py:351"),
    "rrr_expand_streamed": (
        "src/repro_torch/kernels/csrc/rrr_expand.cu",
        "src/repro/kernels/rrr_expand.py:271"),
    "rrr_expand_ic": (
        "src/repro_torch/kernels/csrc/rrr_expand.cu",
        "src/repro/kernels/rrr_expand.py:351 fused with the XLA coin draw "
        "at src/repro/core/rrr.py:309"),
    "cascade_ic": (
        "src/repro_torch/kernels/csrc/rrr_expand.cu",
        "src/repro/kernels/rrr_expand.py:271 (its cascade role) fused with "
        "the XLA live-edge draw at src/repro/core/cascade.py:231"),
    "rrr_expand_lt": (
        "src/repro_torch/kernels/csrc/rrr_expand.cu",
        "src/repro/kernels/rrr_expand.py:351 (its LT role) fused with the "
        "XLA selection draw at src/repro/core/rrr.py:326"),
    "cascade_lt": (
        "src/repro_torch/kernels/csrc/rrr_expand.cu",
        "src/repro/kernels/rrr_expand.py:271 (its LT cascade role) fused "
        "with the XLA one-hot draw at src/repro/core/cascade.py:243"),
    "coin_pack": (
        "src/repro_torch/kernels/csrc/coin_pack.cu",
        "src/repro/core/rrr.py:309 (XLA draw, no TPU kernel)"),
    "greedy_pick": (
        "src/repro_torch/kernels/csrc/greedy_pick.cu",
        "src/repro/kernels/greedy_pick.py:197"),
    "bucket_insert": (
        "src/repro_torch/kernels/csrc/bucket_insert.cu",
        "src/repro/kernels/bucket_insert.py:214"),
    "coverage": (
        "src/repro_torch/kernels/csrc/coverage.cu",
        "src/repro/kernels/coverage.py:45"),
    "topk_gain": (
        "src/repro_torch/kernels/csrc/topk_gain.cu",
        "src/repro/kernels/topk_gain.py:55"),
    "lazy_greedy": (
        "src/repro_torch/kernels/csrc/lazy_greedy.cu",
        "src/repro/kernels/lazy_greedy.py:229"),
    "bucket_insert_stream": (
        "src/repro_torch/kernels/csrc/bucket_insert.cu",
        "src/repro/kernels/bucket_insert.py:266"),
    "bucket_gains": (
        "src/repro_torch/kernels/csrc/bucket_gains.cu",
        "src/repro/kernels/bucket.py:37"),
    "greedy_pick_batch": (
        "src/repro_torch/kernels/csrc/greedy_pick.cu",
        "src/repro/kernels/greedy_pick.py:197 (vmapped over queries at "
        "src/repro/kernels/ops.py:68)"),
    "lazy_greedy_batch": (
        "src/repro_torch/kernels/csrc/lazy_greedy.cu",
        "src/repro/kernels/lazy_greedy.py:229 (vmapped over queries at "
        "src/repro/kernels/ops.py:83)"),
    "topk_gain_batch": (
        "src/repro_torch/kernels/csrc/topk_gain.cu",
        "src/repro/kernels/topk_gain.py:55 (vmapped over queries at "
        "src/repro/core/maxcover.py:141)"),
    "compact_rows": (
        "src/repro_torch/kernels/csrc/greedy_pick.cu",
        "src/repro/kernels/greedy_pick.py:197 and "
        "src/repro/kernels/lazy_greedy.py:229 (their row sweeps, read once "
        "into the compact layout's list)"),
    "greedy_pick_compact": (
        "src/repro_torch/kernels/csrc/greedy_pick.cu",
        "src/repro/kernels/greedy_pick.py:197 (the picks, over the list)"),
    "lazy_greedy_compact": (
        "src/repro_torch/kernels/csrc/lazy_greedy.cu",
        "src/repro/kernels/lazy_greedy.py:229 (the picks, over the list)"),
}


def emit(**fields):
    print(json.dumps(fields), flush=True)


# Wall seconds of each part of the run, in order (phase `done`).
LAPS = []


def lap(label: str):
    """End the part ``label`` of the run at the current wall time."""
    LAPS.append((label, time.perf_counter()))


def lap_seconds(t_start: float) -> dict:
    out, last = {}, t_start
    for label, t in LAPS:
        out[label] = out.get(label, 0.0) + t - last
        last = t
    return out


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


def once(fn):
    """(fn(), its CUDA-event ms): one call, for a slow plain version."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


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
    # with the optional inputs: valid-first rows (other words past each
    # count), the frontier's summary; the emitted summary and count
    cnt = torch.randint(0, df + 1, (n,), generator=gen,
                        dtype=torch.int32).to(dev)
    lines = rrr_expand.line_summary(frontier)
    for name, step, plain, args in (
            ("rrr_expand_resident", rrr_expand.rrr_expand_step_resident,
             rrr_expand.expand_step_resident_plain,
             (frontier, visited, nbr, gidx, plane)),
            ("rrr_expand_streamed", rrr_expand.rrr_expand_step,
             rrr_expand.expand_step_plain,
             (frontier, visited, nbr, rand_words(gen, n, df, w, dev=dev)))):
        outs = []
        for fn in (step, plain):
            nl = torch.empty_like(lines)
            count = torch.empty(1, dtype=torch.int32, device=dev)
            outs.append((*fn(*args, slots=cnt, lines=lines, next_lines=nl,
                             count=count), nl, count))
        errs[name] = max(errs[name], require_equal(
            f"{name} with slots and lines", *outs, n=n, df=df, W=w))

    key = prng.key(7).fold_in(3)
    err = 0
    for n_c, chunk, n_chunks, w_c, dens in ((301, 3, 2, 3, 3),
                                            (97, 2, 3, 33, 0),
                                            (64, 4, 2, 1, 1),
                                            (262144, 16, 1, 40, 12)):
        # W = 3, 33 and 1 take the 4-byte path (33: eight 16-byte chunks'
        # worth and a tail; half the frontier bits set, so every chunk
        # hashes); the last shape's flat draw index passes 2**32
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
    errs["rrr_expand_ic"] = parity_ic(gen, dev)
    errs["cascade_ic"] = parity_cascade(gen, dev)
    lap("parity")
    errs["rrr_expand_lt"] = parity_lt_push(gen, dev)
    lap("parity rrr_expand_lt")
    errs["cascade_lt"] = parity_lt_cascade(gen, dev)
    lap("parity cascade_lt")

    err = 0
    for m, n_g, w_g, k, ex in ((3, 1001, 5, 12, [[1, -1, 5000], [0, 2, 3],
                                                 [-1, -1, -1]]),
                               (2, 10, 2, 15, [[4], [-1]])):
        rows_g = rand_words(gen, m, n_g, w_g, dev=dev)
        for _ in range(3):
            rows_g &= rand_words(gen, m, n_g, w_g, dev=dev)
        rows_g[:, 7 % n_g] = rows_g[:, 2 % n_g]           # ties
        exc = torch.tensor(ex, dtype=torch.int32, device=dev)
        want = greedy_pick.greedy_plain(rows_g, k, exc)
        for cap in (0, None):       # the full sweep, then with its handover
            err = max(err, require_equal(
                "greedy_pick", greedy_pick.greedy_dense(rows_g, k, exc, cap),
                want, m=m, n=n_g, W=w_g, k=k, cap=cap))
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
    errs.update(parity_slice2(gen, dev))
    for name, err in parity_receivers(dev).items():
        errs[name] = max(errs[name], err)
    errs.update(parity_slice3(gen, dev))
    for name, err in parity_layouts(gen, dev).items():
        errs[name] = max(errs.get(name, 0), err)
    torch.cuda.synchronize()
    lap("parity")
    return errs


def check_swept(name, swept, n: int, k: int):
    tiles = lazy_greedy.num_row_tiles(n)
    if not all(tiles <= int(t) <= k * tiles for t in swept):
        raise AssertionError(f"{name}: tiles_swept {swept.tolist()} outside "
                             f"[{tiles}, {k * tiles}]")


def full_list(rows, cap: int = 0):
    """The compact layout's list of ``rows`` whatever their density (one
    compaction with room for ``cap`` entries, by default every word)."""
    lists = greedy_pick.compact_rows(rows, cap or rows.numel())
    return lists._replace(entries=lists.entries[:lists.nonzero_words])


def parity_layouts(gen, dev) -> dict:
    """The machine axis's two layouts: the wrappers pick the compact one
    on sparse rows and the dense sweep on dense ones, and each layout of
    each solve (forced) equals the plain solve and its own plain version;
    the compaction equals its plain version as sets per row.  Sparse rows
    about 1% non-zero at W = 5 and 36 with ties across tiles, excluded
    listed rows, a machine whose listed rows are all excluded, a machine
    of zero rows, k past the listed rows and rows longer than a lane sums
    alone; dense rows about 25% bits set; sparser rows (3% of the words)
    whose list passes the compact layout's capacity at m = 1, so that the
    wrapper's one compaction counts past its allocation and the dense
    sweep runs.  On the dense layout the wrapper's launches are the dense
    kernel and, where ``stats`` reports a handover, one more compaction
    and the compact picks; each dense kernel is also held to the plain
    solve as a full sweep (cap 0) and with its handover forced after
    pick 2 (cap the residual it counted there)."""
    errs = dict.fromkeys(("compact_rows", "greedy_pick", "greedy_pick_compact",
                          "lazy_greedy", "lazy_greedy_compact"), 0)
    for m, n, w, k, share, case in ((3, 1001, 5, 60, 0.01, "sparse"),
                                    (4, 777, 36, 30, 0.005, "sparse"),
                                    (3, 1000, 36, 12, 1.0, "dense"),
                                    (1, 4096, 1024, 20, 0.03, "overflow")):
        rows = rand_words(gen, m, n, w, dev=dev) & rand_words(gen, m, n, w,
                                                              dev=dev)
        if share < 1:
            keep = (torch.rand((m, n, w), generator=gen) < share).to(dev)
            if case == "sparse":
                keep[:, ::97] = True                 # long rows
            rows = torch.where(keep, rows, 0)
        rows[:, 40] = rows[:, 7]                     # a tie across tiles
        ex = torch.full((m, n), -1, dtype=torch.int32, device=dev)
        if case == "sparse":
            ex[0, :3] = torch.tensor([7, n + 5, 3])  # listed rows, an id past n
            listed = (rows[2] != 0).any(1).nonzero()[:, 0]
            ex[2, :listed.numel()] = listed.to(torch.int32)  # all excluded
            rows[1] = 0                              # a machine of zero rows
        want = greedy_pick.greedy_plain(rows, k, ex)
        want_lazy = lazy_greedy.lazy_plain(rows, k, ex)[:4]
        plain_lists = greedy_pick.compact_rows_plain(rows)
        lists = full_list(rows)
        shape = dict(m=m, n=n, W=w, k=k, case=case,
                     nonzero_words=plain_lists.nonzero_words)
        errs["compact_rows"] = max(errs["compact_rows"], require_equal(
            "compact_rows", greedy_pick.canonical_lists(lists),
            greedy_pick.canonical_lists(plain_lists), **shape))
        layout = "compact" if case == "sparse" else "dense"
        for name, wrapper, dense, compact, compact_plain, ref in (
                ("greedy_pick", greedy_pick.greedy_maxcover_resident,
                 greedy_pick.greedy_dense, greedy_pick.greedy_compact,
                 greedy_pick.greedy_compact_plain, want),
                ("lazy_greedy", lazy_greedy.greedy_maxcover_lazy,
                 lazy_greedy.lazy_dense, lazy_greedy.lazy_compact,
                 lazy_greedy.lazy_compact_plain, want_lazy)):
            ops.reset_launches()
            stats = {}
            got = wrapper(rows, k, ex, stats=stats)
            ran = {k_: v for k_, v in ops.LAUNCHES.items() if v}
            kernel = name if layout == "dense" else name + "_compact"
            handed = int(stats.get("handover_pick") is not None)
            want_ran = {"compact_rows": 1 + handed, kernel: 1}
            if handed:
                want_ran[name + "_compact"] = 1
            if stats["layout"] != layout or ran != want_ran or (
                    ops.HANDOVERS[name] != handed):
                raise AssertionError(f"{name} {case}: layout "
                                     f"{stats['layout']}, launches {ran}, "
                                     f"handovers {ops.HANDOVERS}")
            err = require_equal(kernel, got[:4], ref, via="wrapper", **shape)
            full = {}
            got_f = dense(rows, k, ex, cap=0, stats=full)
            cap = full["residual"][min(2, len(full["residual"]) - 1)]
            got_h = dense(rows, k, ex, cap=cap)
            got_d = dense(rows, k, ex)
            got_c = compact(rows, k, ex, lists)
            if name == "lazy_greedy":
                for g in (got, got_f, got_h, got_d, got_c):
                    check_swept(name, g[4], n, k)
            errs[name] = max(errs[name], err * (layout == "dense"),
                             require_equal(name, got_d[:4], ref, **shape),
                             require_equal(name, got_f[:4], ref, cap=0,
                                           **shape),
                             require_equal(name, got_h[:4], ref, cap=cap,
                                           **shape))
            errs[name + "_compact"] = max(
                errs[name + "_compact"], err * (layout == "compact"),
                require_equal(name + "_compact", got_c[:4], ref, **shape),
                require_equal(name + "_compact", got_c[:4],
                              compact_plain(rows, k, ex, lists)[:4],
                              against="its plain version", **shape))
    return errs


def ic_graph_step(gen, g, w, chunk, dens, dev):
    """An IC step on graph ``g``: its tables (with the pull's forward
    tables), a frontier of density 2^-dens with a tenth of its words all
    ones, visited a superset of it, and one key per chunk."""
    n = g.num_vertices
    nbr, prob, wt = csr.padded_adjacency(g)
    t = rrr._Tables(nbr, prob, wt, *csr.padded_forward_adjacency(g),
                    model="IC", coin_chunk=chunk)
    f = rand_words(gen, n, w, dev=dev)
    for _ in range(dens):
        f &= rand_words(gen, n, w, dev=dev)
    f[(torch.rand((n, w), generator=gen) < 0.1).to(dev)] = -1
    vis = f | (rand_words(gen, n, w, dev=dev) & rand_words(gen, n, w,
                                                            dev=dev))
    keys = [prng.key(11).fold_in(n).fold_in(c) for c in range(t.n_chunks)]
    return t, f, vis, keys


def ic_inputs(gen, n, df, d, w, chunk, dens, dev):
    """An IC step on a random graph: in-degrees Poisson(df) cut at d
    (vertex 0 at d; valid slots first, -1 after), a fifth of the
    probabilities zero (:func:`ic_graph_step` for the rest)."""
    deg = torch.poisson(torch.full((n,), float(df)), generator=gen
                        ).long().clamp(max=d)
    deg[0] = d
    src = torch.randint(0, n, (n, d), generator=gen)
    keep = torch.arange(d)[None] < deg[:, None]
    dst = torch.arange(n)[:, None].expand(n, d)
    probs = torch.rand(int(keep.sum()), generator=gen) * 0.6
    probs[torch.rand(probs.shape[0], generator=gen) < 0.2] = 0.0
    g = csr.from_edge_list(src[keep].numpy(), dst[keep].numpy(), n,
                           probs=probs.numpy(), device=dev)
    return ic_graph_step(gen, g, w, chunk, dens, dev)


def push_pair(t, frontier, visited, keys):
    """The push kernel and its plain version from copies of one step's
    inputs: (next plane, visited, next list sorted, frontier after) of
    each."""
    n, w = frontier.shape
    words = rrr_expand.live_words(frontier)
    outs = []
    for fn in (rrr_expand.rrr_expand_push_ic,
               rrr_expand.expand_step_ic_push_plain):
        f, vis, nxt = frontier.clone(), visited.clone(), torch.zeros_like(
            frontier)
        listed = torch.empty(n * w, dtype=torch.int32, device=f.device)
        count = torch.zeros(1, dtype=torch.int32, device=f.device)
        fn(words, f, vis, t.nbr, t.prob_p, keys, t.chunk, nxt, listed,
           count)
        outs.append((nxt, vis, listed[:int(count)].sort().values, f))
        del f, vis, nxt, listed
    return outs


def check_push(kernel, label, name="rrr_expand_ic"):
    """The push left the frontier it read zero and listed each word of
    the next plane once."""
    if bool(kernel[3].any()):
        raise AssertionError(f"{name}: frontier not cleared ({label})")
    if kernel[2].unique().numel() != kernel[2].numel():
        raise AssertionError(f"{name}: a word listed twice ({label})")


def parity_ic(gen, dev) -> int:
    """rrr_expand_ic against its plain version (planes word for word,
    lists as sorted sets), and the dense entry point around it against
    the pull's plain version and the composed coin_pack +
    rrr_expand_resident route: W = 1, odd W, 1-3 chunks, all-ones
    frontier words, invalid and p = 0 slots, a flat draw index past 2^32
    (the fourth shape), a star (every leaf pushes into the hub's words)
    and a reverse star (one reverse row of 4,999 slots)."""
    err = 0
    cases = [(dict(n=n, df=df, d=d, W=w, chunk=chunk, dens=dens),
              lambda n=n, df=df, d=d, w=w, chunk=chunk, dens=dens:
              ic_inputs(gen, n, df, d, w, chunk, dens, dev))
             for n, df, d, w, chunk, dens in ((1001, 3, 5, 1, 3, 1),
                                              (301, 4, 11, 5, 4, 0),
                                              (4093, 4, 16, 33, 16, 2),
                                              (262144, 2, 16, 40, 16, 4))]
    cases += [(dict(graph="star", n=5000, W=7), lambda: ic_graph_step(
        gen, generators.star(5000, device=dev), 7, 32, 3, dev)),
              (dict(graph="reverse star", n=5000, W=7), lambda: ic_graph_step(
                  gen, csr.from_edge_list(np.arange(1, 5000),
                                          np.zeros(4999, np.int64), 5000,
                                          seed=2, device=dev),
                  7, 32, 3, dev))]
    for shape, make in cases:
        t, f, vis, keys = make()
        shape.update(n_chunks=t.n_chunks,
                     max_flat_index=32 * f.shape[1] * t.n * t.chunk)
        kernel, plain = push_pair(t, f, vis, keys)
        err = max(err, require_equal("rrr_expand_ic", kernel, plain,
                                     against="push plain", **shape))
        check_push(kernel, shape)
        got = rrr_expand.rrr_expand_step_ic(f, vis, t.nbr, t.prob_p, keys,
                                            t.chunk)
        plane = coins.coin_plane(keys, t.prob_p, f, t.chunk).reshape(
            -1, f.shape[1])
        for against, want in (
                ("step", kernel[:2]),
                ("pull plain", rrr_expand.expand_step_ic_plain(
                    f, vis, t.nbr_c, t.gidx, t.prob_p, keys, t.chunk)),
                ("composed", rrr_expand.rrr_expand_step_resident(
                    f, vis, t.nbr_c, t.gidx, plane))):
            err = max(err, require_equal("rrr_expand_ic", got, want,
                                         against=against, **shape))
        if not int((got[0] != 0).sum()):
            raise AssertionError(f"rrr_expand_ic: no coin fired ({shape})")
        del plane, kernel, plain, got
    return err


CASCADE_LANES = (1, 2, 4, 8, 16, 32)


def cascade_step(g, num_sims, coin_chunk, dev, key, *, seeds=None,
                 gen=None, model="IC"):
    """One cascade step's inputs on graph ``g`` (``model`` IC or WC: for
    cascade_ic, LT: for cascade_lt): its reverse table, the chunk width
    (IC) or the cumulative weights and row codes (LT), the key table,
    and a frontier and visited plane — the first step from ``seeds``
    (frontier = visited = the seeds' lane words, as
    ``cascade.simulate_cascades`` starts), or, with ``gen``, every word
    non-zero (pad lanes too) over a sparse visited plane."""
    nbr, prob, wt = csr.padded_adjacency(g)
    chunk, n_chunks, _ = rrr._coin_chunks(nbr.shape[1], coin_chunk)
    n = g.num_vertices
    if seeds is not None:
        smask = cascade.seeds_to_mask(n, seeds, device=dev)
        f = torch.where(smask[:, None], bitset.lane_words(num_sims, dev)[
            None], 0).to(torch.int32)
        vis = f.clone()
    else:
        w = bitset.num_words(num_sims)
        f = rand_words(gen, n, w, dev=dev) | 1
        vis = rand_words(gen, n, w, dev=dev) & rand_words(gen, n, w, dev=dev)
    if model == "LT":
        cumw, rows = rrr_expand.lt_tables(nbr, rrr.xla_cumsum(wt))
        step = dict(model=model, nbr=nbr, cumw=cumw, wt=wt, rows=rows,
                    num_sims=num_sims,
                    keys=rrr_expand.lt_cascade_keys(key, num_sims, dev))
    else:
        step = dict(model=model, nbr=nbr, chunk=chunk, num_sims=num_sims,
                    prob=cascade._edge_prob(nbr, prob, wt, model),
                    keys=rrr_expand.cascade_keys(key, n_chunks, num_sims, dev))
    return step, f, vis


def cascade_name(step) -> str:
    return "cascade_lt" if step["model"] == "LT" else "cascade_ic"


def run_cascade_step(step, f, vis, lanes=None, count=None):
    """cascade_ic or cascade_lt on one step (``lanes`` None: the width
    the cascade takes for these rows)."""
    if step["model"] == "LT":
        return rrr_expand.cascade_step_lt(
            f, vis, step["nbr"], step["cumw"], step["rows"], step["keys"],
            step["num_sims"], count=count, lanes=lanes)
    return rrr_expand.cascade_step_ic(
        f, vis, step["nbr"], step["prob"], step["keys"], step["chunk"],
        step["num_sims"], count=count, lanes=lanes)


def plain_cascade_step(step, f, vis, count=None):
    if step["model"] == "LT":
        return rrr_expand.cascade_step_lt_plain(
            f, vis, step["nbr"], step["cumw"], step["rows"], step["keys"],
            step["num_sims"], count=count)
    return rrr_expand.cascade_step_ic_plain(
        f, vis, step["nbr"], step["prob"], step["keys"], step["chunk"],
        step["num_sims"], count=count)


def check_cascade_step(step, f, vis, want, shape) -> int:
    """The cascade kernel at every lane group width against ``want`` (its
    plain version's result), with its count of new words."""
    err = 0
    name = cascade_name(step)
    new_words = int((want[0] != 0).sum())
    for lanes in CASCADE_LANES:
        count = torch.full((1,), -1, dtype=torch.int32, device=f.device)
        err = max(err, require_equal(
            name, run_cascade_step(step, f, vis, lanes, count), want,
            lanes=lanes, new_words=new_words, **shape))
        if int(count) != new_words:
            raise AssertionError(f"{name}: count {int(count)} != "
                                 f"{new_words} new words ({shape})")
    return err


def parity_cascade(gen, dev) -> int:
    """cascade_ic against its plain version, at every lane group width:
    the IMM command's graph at its first cascade step (100 random seeds,
    64 simulations), with every frontier word live (64 and 100
    simulations: pad lanes), there also against the plane route it
    replaces (rrr_expand_streamed over the live-edge plane); hub rows (a
    reverse star of 4,999 slots, the IMM-size rmat graph); n_chunks > 1
    (the supercritical graph, and a chunk of 3)."""
    args = im_driver.parser().parse_args(FULL)
    err = 0
    g = generators.erdos_renyi(args.n, args.avg_deg, args.seed, device=dev)
    seeds = torch.randperm(args.n, generator=gen)[:100]
    cases = [("imm first step", g, 64, 32, dict(seeds=seeds)),
             ("imm every word live", g, 64, 32, dict(gen=gen)),
             ("imm every word live", g, 100, 32, dict(gen=gen)),
             ("imm, chunk 3", g, 64, 3, dict(gen=gen)),
             ("reverse star", csr.from_edge_list(
                 np.arange(1, 5000), np.zeros(4999, np.int64), 5000, seed=2,
                 device=dev), 64, 32, dict(gen=gen)),
             ("rmat", im_driver.make_graph("rmat", args.n, args.avg_deg,
                                           args.seed, dev), 64, 32,
              dict(gen=gen)),
             ("supercritical", generators.erdos_renyi(32768, 76.3, args.seed,
                                                      device=dev), 64, 32,
              dict(gen=gen))]
    for label, graph, sims, coin_chunk, how in cases:
        key = prng.key(args.seed).fold_in(99)
        step, f, vis = cascade_step(graph, sims, coin_chunk, dev, key, **how)
        want = plain_cascade_step(step, f, vis)
        shape = dict(input=label, n=graph.num_vertices,
                     d=step["nbr"].shape[1], W=f.shape[1], num_sims=sims,
                     n_chunks=step["keys"].shape[0], chunk=step["chunk"])
        err = max(err, check_cascade_step(step, f, vis, want, shape))
        if label == "imm every word live" and sims == 64:
            nbr, d = step["nbr"], step["nbr"].shape[1]
            chunk, n_chunks, d_pad = rrr._coin_chunks(d, coin_chunk)
            live = cascade._live_mask(nbr, step["prob"], None, key,
                                      model="IC", num_sims=sims, chunk=chunk,
                                      n_chunks=n_chunks, d_pad=d_pad)
            tbl = torch.nn.functional.pad(torch.where(nbr >= 0, nbr, 0),
                                          (0, d_pad - d)).contiguous()
            err = max(err, require_equal(
                "cascade_ic", run_cascade_step(step, f, vis),
                rrr_expand.rrr_expand_step(f, vis, tbl, live),
                against="the plane route", **shape))
            del live, tbl
        if not int((want[0] != 0).sum()):
            raise AssertionError(f"cascade_ic: no edge fired ({shape})")
        del step, f, vis, want
    torch.cuda.empty_cache()
    return err


def lt_sampler_tables(g, coin_chunk: int, forward: bool = True):
    """The LT sampler's tables on graph ``g``: the push's CSR tables
    (``t.lt``, ``graphs.csr.lt_reverse``; no padded table) and, with
    ``forward``, the padded tables and forward gathers of the plane
    route.  ``t.d`` is the largest in-degree."""
    lt = csr.lt_reverse(g)
    if forward:
        nbr, prob, wt = csr.padded_adjacency(g)
        t = rrr._Tables(nbr, prob, wt, *csr.padded_forward_adjacency(g),
                        model="LT", coin_chunk=coin_chunk)
        t.lt = lt
    else:
        t = rrr._Tables(None, None, None, None, None, model="LT",
                        coin_chunk=coin_chunk, forward=False, lt=lt)
    t.d = g.max_in_degree()
    return t


def dips_graph(dev):
    """Rows of 300 to 2,600 in-edges padded to a hub's 5,000: tails that
    dip an ulp below their rows' last sums."""
    rng = np.random.default_rng(0)
    rows = [5000, 300, 400, 520, 700, 900, 1300, 2000, 2600]
    dst = np.repeat(np.arange(len(rows)), rows)
    return csr.from_edge_list(rng.integers(0, 30, dst.size), dst, 30,
                              seed=0, device=dev)


def lt_push_pair(t, frontier, visited, key):
    """rrr_expand_lt and its plain version from copies of one step's
    inputs: (next plane, visited, next list sorted, frontier after)."""
    n, w = frontier.shape
    words = rrr_expand.live_words(frontier)
    outs = []
    for fn in (rrr_expand.rrr_expand_push_lt,
               rrr_expand.expand_step_lt_push_plain):
        f, vis, nxt = frontier.clone(), visited.clone(), torch.zeros_like(
            frontier)
        listed = torch.empty(n * w, dtype=torch.int32, device=f.device)
        count = torch.zeros(1, dtype=torch.int32, device=f.device)
        fn(words, f, vis, t.lt.indptr, t.lt.src, t.lt.cumw, key, nxt,
           listed, count)
        outs.append((nxt, vis, listed[:int(count)].sort().values, f))
        del f, vis, nxt, listed
    return outs


def lt_first_step(t, key, theta: int, dev):
    """The first BFS step of a ``theta``-sample LT draw: the roots'
    frontier, visited and the step's key, derived as the sampler does."""
    kr, kb = key.split()
    frontier = rrr.packed_roots(kr.randint((theta,), 0, t.n, device=dev),
                                t.n)
    return frontier, frontier.clone(), kb.split()[1]


def parity_lt_push(gen, dev) -> int:
    """rrr_expand_lt against its plain version (planes word for word,
    lists as sorted sets), and its dense entry point against the plane
    route it replaces (the selection plane, rrr._lt_mask, through
    rrr_expand_resident): the LT IMM's first sampling step (n = 262,144,
    W = 1,024: the draw index s * n + v passes 2^32), the IMM-size rmat
    graph's (hub rows, binary searched), rows whose padded tails dip
    below their last sums (kept as the reference counts them), a star
    (every leaf pushes into the hub's words), and an empty word list.
    The push reads the CSR tables alone."""
    args = im_driver.parser().parse_args(LT_FULL)
    err = 0
    key = prng.key(args.seed).fold_in(1)
    cases = [
        ("imm first step", lambda: lt_sampler_tables(
            generators.erdos_renyi(args.n, args.avg_deg, args.seed,
                                   device=dev), args.coin_chunk), True),
        ("rmat first step", lambda: lt_sampler_tables(
            im_driver.make_graph("rmat", args.n, args.avg_deg, args.seed,
                                 dev), args.coin_chunk, forward=False),
         False),
        ("dips", lambda: lt_sampler_tables(dips_graph(dev), 32), True),
        ("star", lambda: lt_sampler_tables(
            generators.star(5000, device=dev), 32), True)]
    for label, make, composed in cases:
        t = make()
        if "first step" in label:
            f, vis, sub = lt_first_step(t, key, args.max_theta, dev)
        else:
            f = rand_words(gen, t.n, 7, dev=dev)
            vis = f | (rand_words(gen, t.n, 7, dev=dev)
                       & rand_words(gen, t.n, 7, dev=dev))
            sub = key.fold_in(7)
        shape = dict(input=label, n=t.n, d=t.d, W=f.shape[1],
                     edges=t.lt.num_edges,
                     max_flat_index=32 * f.shape[1] * t.n)
        kernel, plain = lt_push_pair(t, f, vis, sub)
        err = max(err, require_equal("rrr_expand_lt", kernel, plain,
                                     against="push plain", **shape))
        check_push(kernel, label, "rrr_expand_lt")
        if not int((kernel[0] != 0).sum()):
            raise AssertionError(f"rrr_expand_lt: no walk went on ({label})")
        del kernel, plain
        if composed:
            got = rrr_expand.rrr_expand_step_lt(f, vis, t.lt.indptr,
                                                t.lt.src, t.lt.cumw, sub)
            plane = rrr._lt_mask(t, sub, f).reshape(t.n * t.d_pad, -1)
            err = max(err, require_equal(
                "rrr_expand_lt", got, rrr_expand.rrr_expand_step_resident(
                    f, vis, t.nbr_c, t.gidx, plane),
                against="the plane route", **shape))
            del plane, got
        del t, f, vis
        torch.cuda.empty_cache()
    # an empty list launches nothing and lists nothing
    f = torch.zeros((5, 2), dtype=torch.int32, device=dev)
    count = torch.full((1,), 9, dtype=torch.int32, device=dev)
    before = ops.LAUNCHES["rrr_expand_lt"]
    rrr_expand.rrr_expand_push_lt(
        torch.zeros(0, dtype=torch.int32, device=dev), f, f.clone(),
        torch.arange(6, dtype=torch.int32, device=dev),
        torch.zeros(5, dtype=torch.int32, device=dev),
        torch.zeros(5, device=dev), key, f.clone(),
        torch.empty(10, dtype=torch.int32, device=dev), count)
    if int(count) or ops.LAUNCHES["rrr_expand_lt"] != before:
        raise AssertionError("rrr_expand_lt: an empty list launched or "
                             "listed")
    emit(phase="parity", kernel="rrr_expand_lt", input="empty list",
         max_abs_err=0)
    return err


def parity_lt_cascade(gen, dev) -> int:
    """cascade_lt against its plain version at every lane group width:
    the LT spread's first step on the IMM command's graph (100 random
    seeds, 64 simulations), there also against the plane route it
    replaces (rrr_expand_streamed over cascade._live_mask's LT plane);
    every frontier word live (64 and 100 simulations: pad lanes); the
    IMM-size rmat graph (hub rows, binary searched); a reverse star with
    its rows' sums permuted (4,999 slots, marked and searched whole)."""
    args = im_driver.parser().parse_args(LT_FULL)
    err = 0
    g = generators.erdos_renyi(args.n, args.avg_deg, args.seed, device=dev)
    seeds = torch.randperm(args.n, generator=gen)[:100]
    rev = csr.from_edge_list(np.arange(1, 5000), np.zeros(4999, np.int64),
                             5000, seed=2, device=dev)
    cases = [("lt first step", g, 64, dict(seeds=seeds)),
             ("every word live", g, 64, dict(gen=gen)),
             ("every word live", g, 100, dict(gen=gen)),
             ("rmat", im_driver.make_graph("rmat", args.n, args.avg_deg,
                                           args.seed, dev), 64,
              dict(gen=gen)),
             ("reverse star, rows permuted", rev, 64, dict(gen=gen))]
    for label, graph, sims, how in cases:
        key = prng.key(args.seed).fold_in(99)
        step, f, vis = cascade_step(graph, sims, 32, dev, key, model="LT",
                                    **how)
        if label.endswith("permuted"):
            perm = torch.randperm(step["nbr"].shape[1], generator=gen).to(dev)
            step["cumw"], step["rows"] = rrr_expand.lt_tables(
                step["nbr"], step["cumw"][:, perm])
        want = plain_cascade_step(step, f, vis)
        shape = dict(input=label, n=graph.num_vertices,
                     d=step["nbr"].shape[1], W=f.shape[1], num_sims=sims,
                     sorted_rows=int((step["rows"] >= 0).sum()))
        err = max(err, check_cascade_step(step, f, vis, want, shape))
        if label == "lt first step":
            nbr, d = step["nbr"], step["nbr"].shape[1]
            live = cascade._live_mask(nbr, None, step["wt"], key, model="LT",
                                      num_sims=sims, chunk=d, n_chunks=1,
                                      d_pad=d)
            tbl = torch.where(nbr >= 0, nbr, 0).contiguous()
            err = max(err, require_equal(
                "cascade_lt", run_cascade_step(step, f, vis),
                rrr_expand.rrr_expand_step(f, vis, tbl, live),
                against="the plane route", **shape))
            del live, tbl
        if not int((want[0] != 0).sum()):
            raise AssertionError(f"cascade_lt: no edge fired ({shape})")
        del step, f, vis, want
    torch.cuda.empty_cache()
    return err


def parity_slice2(gen, dev) -> dict:
    """The gain sweeps, the lazy solve and the stream receiver: W odd
    (4-byte loads) and W a multiple of 4 (16-byte loads), ties within
    and across row tiles, picked and excluded rows, a machine with every
    row picked, skewed gains that let the lazy solve skip, full buckets,
    ids of -1, streams of one chunk and chunks larger than one staging
    buffer."""
    errs = dict.fromkeys(("coverage", "topk_gain", "lazy_greedy",
                          "bucket_insert_stream"), 0)
    for m, n_g, w_g in ((3, 1001, 5), (2, 777, 36)):
        rows_g = rand_words(gen, m, n_g, w_g, dev=dev)
        for _ in range(3):
            rows_g &= rand_words(gen, m, n_g, w_g, dev=dev)
        rows_g[:, 700] = rows_g[:, 3]                      # ties
        cov = rand_words(gen, m, w_g, dev=dev) & rand_words(gen, m, w_g,
                                                              dev=dev)
        picked = (torch.rand((m, n_g), generator=gen) < 0.3).to(dev)
        picked[0, 3] = True
        picked[-1] = True                                  # all picked
        errs["coverage"] = max(errs["coverage"], require_equal(
            "coverage", [coverage.marginal_gain(rows_g, cov)],
            [coverage.marginal_gain_plain(rows_g, cov)], m=m, n=n_g, W=w_g))
        errs["topk_gain"] = max(errs["topk_gain"], require_equal(
            "topk_gain", topk_gain.best_gain_index(rows_g, cov, picked),
            topk_gain.best_gain_index_plain(rows_g, cov, picked), m=m,
            n=n_g, W=w_g))
    for m, n_g, w_g, k, ex, skew in (
            (3, 1001, 5, 12, [[1, -1, 5000], [0, 2, 3], [-1, -1, -1]], False),
            (2, 10, 2, 15, [[4], [-1]], False),
            (2, 20000, 36, 30, [[-1], [17]], True)):
        rows_g = rand_words(gen, m, n_g, w_g, dev=dev)
        for _ in range(3):
            rows_g &= rand_words(gen, m, n_g, w_g, dev=dev)
        if skew:                          # a few heavy rows, many light
            heavy = (torch.rand((m, n_g, 1), generator=gen) < 0.02).to(dev)
            rows_g = torch.where(heavy, rows_g | rand_words(
                gen, m, n_g, w_g, dev=dev), rows_g & 0x00010001)
        rows_g[:, 40 % n_g] = rows_g[:, 7 % n_g]    # a tie across tiles
        exc = torch.tensor(ex, dtype=torch.int32, device=dev)
        want = lazy_greedy.lazy_plain(rows_g, k, exc)[:4]
        for cap in (0, None):       # the full sweep, then with its handover
            *got, swept = lazy_greedy.lazy_dense(rows_g, k, exc, cap)
            check_swept("lazy_greedy", swept, n_g, k)
            errs["lazy_greedy"] = max(errs["lazy_greedy"], require_equal(
                "lazy_greedy", got, want, m=m, n=n_g, W=w_g, k=k, cap=cap,
                tiles_swept=swept.tolist(),
                num_tiles=lazy_greedy.num_row_tiles(n_g)))
    b, k = 63, 4
    # the last two chunks exceed what one buffer stages at W = 4096
    for r, c, w_b in ((1, 301, 7), (3, 100, 8), (57, 14, 36), (5, 8, 4096),
                      (2, 13, 4096)):
        ids = torch.randint(-1, 5000, (r, c), generator=gen,
                            dtype=torch.int32)
        args = (ids.to(dev), rand_words(gen, r, c, w_b, dev=dev)
                & rand_words(gen, r, c, w_b, dev=dev),
                rand_words(gen, b, w_b, dev=dev)
                & rand_words(gen, b, w_b, dev=dev),
                torch.randint(0, k + 1, (b,), generator=gen,
                              dtype=torch.int32).to(dev),
                torch.full((b, k), -1, dtype=torch.int32, device=dev),
                (torch.rand(b, generator=gen) * 40 * w_b / 7).to(dev))
        errs["bucket_insert_stream"] = max(
            errs["bucket_insert_stream"], require_equal(
                "bucket_insert_stream",
                bucket_insert.bucket_insert_stream(*args),
                bucket_insert.bucket_insert_stream_plain(*args), B=b, R=r,
                C=c, W=w_b, k=k))
    return errs


def parity_receivers(dev) -> dict:
    """The receivers' two regimes of the full-size runs
    (``tools/time_receiver.py``'s :func:`regime_inputs`: 800 candidates
    through 63 buckets, k = 100; filling, every bucket full at candidate
    99 with 700 to go; rejecting, one accept a bucket) at the runs'
    widths (1,024 and 4,096 words: the round's rows are far wider than
    the 6 a stream chunk stages at once) and at an odd one, as one chunk
    and as a stream of 8 chunks: the launch against the scan, its
    figures against the grouped plain walk."""
    errs = dict.fromkeys(("bucket_insert", "bucket_insert_stream"), 0)
    for regime in ("filling", "rejecting"):
        for w in (1024, 4096, 1023):
            ids, rows, *st = regime_inputs(regime, 800, 63, w, 100, dev)
            for name in errs:
                a = ((ids.reshape(8, -1), rows.reshape(8, -1, rows.shape[1]))
                     if name == "bucket_insert_stream" else (ids, rows))
                want = (bucket_insert.bucket_insert_stream_plain
                        if name == "bucket_insert_stream"
                        else bucket_insert.bucket_insert_plain)(*a, *st)
                *got, stats = bucket_insert.bucket_insert_with_stats(*a, *st)
                errs[name] = max(errs[name], require_equal(
                    name, got, want, regime=regime, W=w,
                    group=int(stats[0, 4]), cluster=int(stats[0, 5])))
                # the launch's walk, figure for figure
                walk = bucket_insert.bucket_insert_grouped_plain(
                    *a, *st, group=bucket_insert.GROUP)
                if not torch.equal(stats[:, :4].cpu(), walk[3]):
                    raise AssertionError(f"{name}: the launch's figures "
                                         f"differ from the walk's ({regime})")
                fig = summary(a[0], a[1], streaming.StreamState(*st),
                              got[1], stats)
                if (regime == "filling"
                        and fig["last_filled_at"] != st[2].shape[1] - 1):
                    raise AssertionError(f"{name}: a bucket did not fill at "
                                         "candidate k - 1")
                emit(phase="parity", kernel=name, regime=regime, W=w, **fig)
    return errs


def parity_slice3(gen, dev) -> dict:
    """bucket_gains at the receiver's shape (B = 63, W = 4096), at odd
    shapes, unaligned starts, one long row and many buckets; the three query-axis kernels over one
    shared pool, with a tie across tiles, exclusions (pads, ids past n)
    and a query that excludes nothing, at B = 8, at B = 1, at B = 16
    with W = 4096 (two query groups; dense rows, and sparse ones whose
    zero chunks the senders skip), at B = 12 (a last group of 4), at odd
    W from an unaligned start, and
    with exclusions that make the queries' picks diverge."""
    errs = dict.fromkeys(("bucket_gains", "greedy_pick_batch",
                          "lazy_greedy_batch", "topk_gain_batch"), 0)
    for b, w, off in ((63, 4096, 0), (1, 1, 0), (7, 33, 0), (64, 2053, 0),
                      (63, 4096, 1), (5, 1029, 3), (200, 4096, 0),
                      (1, 65536, 0), (63, 4097, 0)):
        row = rand_words(gen, w + off, dev=dev)[off:]
        covers = (rand_words(gen, b, w + off, dev=dev)
                  & rand_words(gen, b, w + off, dev=dev))[:, off:].contiguous()
        covers[0] = 0
        errs["bucket_gains"] = max(errs["bucket_gains"], require_equal(
            "bucket_gains", [bucket.bucket_gains(row, covers)],
            [bucket.bucket_gains_plain(row, covers)], B=b, W=w,
            row_offset_words=off))
    for n_g, w_g, k, b, case in ((1001, 5, 12, 8, "random"),
                                 (20000, 36, 30, 8, "random"),
                                 (2000, 36, 20, 8, "diverge"),
                                 (1001, 5, 12, 1, "random"),
                                 (600, 4096, 8, 16, "random"),
                                 (600, 4096, 8, 16, "sparse"),
                                 (600, 4096, 8, 12, "random"),
                                 (1001, 7, 12, 8, "unaligned")):
        words = rand_words(gen, n_g * w_g + 1, dev=dev)
        for _ in range(3):
            words &= rand_words(gen, n_g * w_g + 1, dev=dev)
        if case == "sparse":      # most 16-byte chunks zero, as in a pool
            words = torch.where(torch.rand(n_g * w_g + 1, generator=gen
                                           ).to(dev) < 0.002, words, 0)
        # an unaligned start takes the 4-byte loads
        rows_g = (words[1:] if case == "unaligned" else words[:-1]).view(
            n_g, w_g)
        rows_g[40] = rows_g[7]                     # a tie across tiles
        if case == "diverge":          # a quarter of the rows per query
            exc = torch.stack([torch.randperm(n_g, generator=gen)[:n_g // 4]
                               for _ in range(b)]).to(torch.int32).to(dev)
        else:
            exc = torch.randint(-1, n_g + 50, (b, 4), generator=gen,
                                dtype=torch.int32).to(dev)
            exc[0] = -1
        shared = rows_g[None].expand(b, n_g, w_g)
        shape = dict(B=b, n=n_g, W=w_g, k=k, case=case,
                     groups=greedy_pick.query_plan("greedy_pick", b, w_g,
                                                   dev)[1])
        errs["greedy_pick_batch"] = max(errs["greedy_pick_batch"], require_equal(
            "greedy_pick_batch",
            greedy_pick.greedy_maxcover_resident_batch(rows_g, k, exc),
            greedy_pick.greedy_plain(shared, k, exc), **shape))
        *got, swept = lazy_greedy.greedy_maxcover_lazy_batch(rows_g, k, exc)
        tiles = lazy_greedy.num_row_tiles(n_g)
        if not all(tiles <= int(t) <= k * tiles for t in swept):
            raise AssertionError(f"lazy_greedy_batch: tiles_swept "
                                 f"{swept.tolist()} outside [{tiles}, "
                                 f"{k * tiles}]")
        errs["lazy_greedy_batch"] = max(errs["lazy_greedy_batch"], require_equal(
            "lazy_greedy_batch", got, lazy_greedy.lazy_plain(shared, k, exc)[:4],
            tiles_swept=swept.tolist(), **shape))
        cov = rand_words(gen, b, w_g, dev=dev) & rand_words(gen, b, w_g, dev=dev)
        picked = (torch.rand((b, n_g), generator=gen) < 0.3).to(dev)
        picked[-1] = True                                  # all picked
        errs["topk_gain_batch"] = max(errs["topk_gain_batch"], require_equal(
            "topk_gain_batch", topk_gain.best_gain_index_batch(rows_g, cov, picked),
            topk_gain.best_gain_index_plain(shared, cov, picked), B=b, n=n_g,
            W=w_g, case=case))
    return errs


# ---------------------------------------------------------------- phase 4

def paths_agree(dev) -> None:
    """Kernel paths against plain paths, and the card against the CPU:
    identical seeds, theta, coverage and spread.  The kernel paths sample
    on the resident layout (IC: the fused rrr_expand_ic) and on the
    streamed one (IC: coin_pack's plane), and estimate the spread over
    every gather of the cascade (IC auto: cascade_ic; resident and
    streamed: the live-edge plane), which must agree with each other
    and with the CPU; the IC and LT kernel runs' launch counts (set to 0
    just before each) must show their kernels."""
    launches = {}
    for model in ("IC", "LT"):
        results = {}
        for name, device, sampler, solver, use_kernel, engine, gather_s in (
                ("plain-cpu", "cpu", "packed", "scan", False, "packed",
                 "auto"),
                ("plain-gpu", dev, "packed", "scan", False, "packed", "auto"),
                ("kernel-gpu", dev, "kernel", "resident", True, "kernel",
                 "auto"),
                ("kernel-gpu-streamed", dev, "kernel", "resident", True,
                 "kernel", "streamed")):
            g = generators.erdos_renyi(3000, 4.0, seed=5, device=device)
            key = prng.key(5)
            sel = imm.make_randgreedi_selector(4, "streaming", 0.077,
                                               use_kernel=use_kernel,
                                               solver=solver)
            ops.reset_launches()
            res = imm.imm(g, 10, 0.13, key, model=model, selector=sel,
                          max_theta=2048, sampler=sampler, gather=gather_s)
            spreads = [float(cascade.spread(
                g, torch.from_numpy(res.seeds), key.fold_in(99),
                model=model, num_sims=64, engine=engine, gather=gather))
                for gather in ("auto", "resident", "streamed")]
            if len(set(spreads)) != 1:
                raise AssertionError(f"{model} {name}: spreads over the "
                                     f"gathers {spreads}")
            if use_kernel:
                torch.cuda.synchronize()
                launches[f"{model} {name}"] = dict(ops.LAUNCHES)
            results[name] = (res.seeds.tolist(), res.theta,
                             res.coverage_fraction, spreads)
        emit(phase="paths", model=model, **{k: dict(
            seeds=v[0], theta=v[1], coverage_fraction=v[2], spreads=v[3])
            for k, v in results.items()})
        if len({json.dumps(v) for v in results.values()}) != 1:
            raise AssertionError(f"{model}: paths disagree")
    ic = launches["IC kernel-gpu"]
    if (not ic["rrr_expand_ic"] or ic["coin_pack"] or not ic["cascade_ic"]
            or not ic["rrr_expand_streamed"]
            or not ic["rrr_expand_resident"]):
        raise AssertionError(f"IC resident sampling and the spreads "
                             f"launched {ic}")
    lt = launches["LT kernel-gpu"]
    if not (lt["rrr_expand_lt"] and lt["cascade_lt"]):
        raise AssertionError(f"LT resident sampling and the spreads "
                             f"launched {lt}")


# round phase of `paths`: (arguments that change the result, kernel-path
# variants that must not)
ROUND_SWEEP = (
    ({}, (dict(solver="scan", use_kernel=True, chunk_size=8),
          dict(solver="fused", use_kernel=True, chunk_size="auto"),
          dict(solver="resident", use_kernel=True, chunk_size=8),
          dict(solver="lazy", use_kernel=True, chunk_size="auto"),
          dict(solver="lazy", chunk_size=8))),
    (dict(aggregate="pipeline"), (dict(solver="lazy", use_kernel=True),
                                  dict(solver="fused", use_kernel=True))),
    (dict(shuffle="sparse"), (dict(solver="lazy", use_kernel=True,
                                   chunk_size="auto"),)),
    (dict(alpha_trunc=0.125), (dict(solver="resident", use_kernel=True,
                                    chunk_size="auto"),)),
    (dict(survivors=(0, 2, 3)), (dict(solver="lazy", use_kernel=True,
                                      chunk_size=8),)),
    (dict(survivors=(0, 2, 3), aggregate="pipeline"),
     (dict(solver="fused", use_kernel=True),)),
)


def round_paths_agree(dev):
    """The fixed-theta round and the Ripples round at n = 3000, m = 4,
    theta = 2048, k = 10: every kernel path on the card against the
    plain path on the card and on the CPU — identical seeds and
    coverages."""
    n, m, theta, k = 3000, 4, 2048, 10
    for model in ("IC", "LT"):
        tables = {}
        for device in ("cpu", dev):
            g = generators.erdos_renyi(n, 4.0, seed=5, device=device)
            tables[str(device)] = (*csr.padded_adjacency(g),
                                   csr.padded_forward_adjacency(g))

        def run(device, **kw):
            nbr, prob, wt, fwd = tables[str(device)]
            fn, _, _ = greediris.build_round(m=m, n=n, theta=theta, k=k,
                                             max_degree=0, model=model,
                                             fwd=fwd, **kw)
            o = fn(nbr, prob, wt, prng.key(5))
            return (o.seeds.tolist(), int(o.coverage),
                    int(o.global_coverage), int(o.best_local_coverage))

        for fixed, variants in ROUND_SWEEP:
            plain = dict(fixed, sampler="packed", solver="scan")
            results = {"plain-cpu": run("cpu", **plain),
                       "plain-gpu": run(dev, **plain)}
            for v in variants:
                kw = dict(fixed, sampler="kernel", **v)
                results[json.dumps(kw, sort_keys=True)] = run(dev, **kw)
            emit(phase="paths", path="round", model=model, **results)
            if len({json.dumps(r) for r in results.values()}) != 1:
                raise AssertionError(f"round {model} {fixed}: paths disagree")
        results = {}
        for name, device, sampler, use_kernel in (
                ("plain-cpu", "cpu", "packed", False),
                ("plain-gpu", dev, "packed", False),
                ("kernel-gpu", dev, "kernel", True)):
            nbr, prob, wt, fwd = tables[str(device)]
            fn, _ = greediris.build_ripples_round(
                m=m, n=n, theta=theta, k=k, model=model, sampler=sampler,
                use_kernel=use_kernel, fwd=fwd)
            seeds, cov = fn(nbr, prob, wt, prng.key(5))
            results[name] = (seeds.tolist(), int(cov))
        emit(phase="paths", path="ripples", model=model, **results)
        if len({json.dumps(r) for r in results.values()}) != 1:
            raise AssertionError(f"ripples {model}: paths disagree")


SMALL_SERVE = ["--n", "3000", "--avg-deg", "4", "--queries", "16",
               "--batch", "8", "--theta0", "1024", "--slab", "512",
               "--max-theta", "4096", "--k-max", "10", "--refresh-every", "1",
               "--check"]


def serve_paths_agree(dev) -> None:
    """The serving replay at n = 3000 (IC and LT) on the card for every
    solver, against one plain run on the CPU: identical answers (seeds,
    coverages, sigma bounds, certified), and --check OK everywhere; then
    ``im_driver --use-opim`` on the card against the CPU."""
    for model in ("IC", "LT"):
        flags = SMALL_SERVE + ["--model", model]
        want = serve.run(flags + ["--device", "cpu", "--sampler", "packed",
                                  "--solver", "scan"])
        results = {}
        for solver in maxcover.SOLVERS:
            got = serve.run(flags + ["--solver", solver])
            torch.cuda.synchronize()
            same = len(got["answers"]) == len(want["answers"]) and all(
                serve.answers_equal(a, b)
                for a, b in zip(got["answers"], want["answers"]))
            results[solver] = dict(rc=got["rc"], same_as_cpu=same,
                                   generations=got["generations"],
                                   certified=got["certified"])
            if got["rc"] or not same:
                emit(phase="paths", path="serve", model=model, **results)
                raise AssertionError(f"serve {model} {solver}: card != CPU")
        emit(phase="paths", path="serve", model=model, cpu_rc=want["rc"],
             answers=len(want["answers"]), **results)
        if want["rc"]:
            raise AssertionError(f"serve {model}: the CPU check failed")
    opim_flags = ["--n", "3000", "--avg-deg", "4", "--k", "10", "--max-theta",
                  "4096", "--machines", "4", "--use-opim", "--eval-sims", "64"]
    runs = {"kernel-gpu": im_driver.run(opim_flags + [
                "--solver", "lazy", "--use-kernel"]),
            "plain-cpu": im_driver.run(opim_flags + [
                "--sampler", "packed", "--solver", "scan", "--eval-engine",
                "packed", "--device", "cpu"])}
    res = {k: dict(seeds=v["seeds"].tolist(), theta=v["theta"],
                   rounds=v["rounds"], guarantee=v["guarantee"],
                   spread=v["spread"]) for k, v in runs.items()}
    emit(phase="paths", path="opim", **res)
    if len({json.dumps(r) for r in res.values()}) != 1:
        raise AssertionError("opim: card != CPU")


# ---------------------------------------------------------------- phase 5

class PlaneDraws:
    """While open, counts the plane draws: the cascade's live-edge planes
    (``cascade._live_mask``) and the LT sampler's selection planes
    (``rrr._lt_mask``)."""

    def __enter__(self):
        self.count = 0
        self._fns = [(mod, name, getattr(mod, name)) for mod, name in (
            (cascade, "_live_mask"), (rrr, "_lt_mask"))]
        for mod, name, fn in self._fns:
            setattr(mod, name, self._counted(fn))
        return self

    def _counted(self, fn):
        def counted(*args, **kwargs):
            self.count += 1
            return fn(*args, **kwargs)
        return counted

    def __exit__(self, *exc):
        for mod, name, fn in self._fns:
            setattr(mod, name, fn)


def check_ic_spread(run: str, launches: dict, planes: int):
    """A full-size run estimated its spread through cascade_ic, with no
    live-edge plane and no plane kernel."""
    plane_kernels = {k: launches[k] for k in ("rrr_expand_streamed",
                                              "rrr_expand_resident")
                     if launches[k]}
    if not launches["cascade_ic"] or plane_kernels or planes:
        raise AssertionError(f"{run}: the spread launched cascade_ic "
                             f"{launches['cascade_ic']} times, "
                             f"{plane_kernels} and drew {planes} planes")


def full_run():
    """The slice-1 command with the spread's cross-check (FULL_CHECKED):
    the map, packed and kernel engines must give its spread.  Only the
    cross-check's packed engine draws a live-edge plane."""
    ops.reset_launches()
    with PlaneDraws() as planes:
        out = im_driver.run(FULL_CHECKED)
        torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    seeds = out["seeds"]
    check = out["spread_check"]
    emit(phase="full", theta=out["theta"], rounds=out["rounds"],
         coverage_fraction=out["coverage_fraction"], spread=out["spread"],
         n=out["n"], edges=out["edges"], seconds=dict(
             graph=out["graph_s"], sample=out["sample_s"],
             select=out["select_s"], spread=out["spread_s"]),
         bfs_steps=out["bfs_steps"], peak_bytes=out["peak_bytes"],
         live_planes=planes.count, launches=launches,
         spread_check=check)
    real = seeds[seeds >= 0]
    if not (len(real) == 100 and len(set(real.tolist())) == 100
            and real.max() < out["n"]):
        raise AssertionError(f"bad seed set {seeds}")
    if not (0.0 < out["coverage_fraction"] <= 1.0
            and np.isfinite(out["spread"]) and out["spread"] >= len(real)):
        raise AssertionError("coverage or spread out of range")
    if set(check["spread"]) != set(cascade.ENGINES) or set(
            check["spread"].values()) != {out["spread"]}:
        raise AssertionError(f"the spread's cross-check: {check}")
    missing = [k for k in SLICE1 if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    if planes.count != 1:
        raise AssertionError(f"imm: {planes.count} planes drawn; only the "
                             "cross-check's packed engine draws one")
    check_ic_sampling("imm", launches)
    check_ic_spread("imm", launches, planes.count - 1)
    check_layout("imm", launches)
    return launches, out


def streamed_run(full: dict) -> dict:
    """FULL on the sampler's streamed layout (STREAMED) through
    ``im_driver.run``: each IC BFS step draws the coin plane (coin_pack)
    and expands through the gathered mask (rrr_expand_streamed), once
    each a step; the spread steps through cascade_ic as FULL's does.
    Seeds, theta, coverage fraction, BFS steps and spread must be those
    of the ``full`` run.  Launch counts set to 0 just before it and read
    just after."""
    ops.reset_launches()
    with PlaneDraws() as planes:
        out = im_driver.run(STREAMED)
        torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    lo, hi = STREAMED_PREDICTED["sample_s"]
    emit(phase="streamed", theta=out["theta"], rounds=out["rounds"],
         coverage_fraction=out["coverage_fraction"], spread=out["spread"],
         seconds=dict(graph=out["graph_s"], sample=out["sample_s"],
                      select=out["select_s"], spread=out["spread_s"]),
         bfs_steps=out["bfs_steps"], peak_bytes=out["peak_bytes"],
         live_planes=planes.count, launches=launches,
         predicted=STREAMED_PREDICTED,
         sample_s_in_prediction=lo <= out["sample_s"] <= hi,
         peak_over_prediction=out["peak_bytes"]
         / STREAMED_PREDICTED["peak_bytes"])
    differ = {key: (out[key], full[key]) for key in (
        "theta", "rounds", "coverage_fraction", "spread", "bfs_steps")
        if out[key] != full[key]}
    if differ or out["seeds"].tolist() != full["seeds"].tolist():
        raise AssertionError(f"imm streamed: {differ or 'other seeds'} "
                             "than the resident layout's run")
    steps = out["bfs_steps"]
    drawn = {k: launches[k] for k in STREAMED_RUN + (
        "rrr_expand_ic", "rrr_expand_resident")}
    if drawn != dict(coin_pack=steps, rrr_expand_streamed=steps,
                     rrr_expand_ic=0, rrr_expand_resident=0) \
            or not launches["cascade_ic"] or planes.count:
        raise AssertionError(f"imm streamed: {steps} BFS steps launched "
                             f"{drawn}, cascade_ic {launches['cascade_ic']} "
                             f"times, and drew {planes.count} planes")
    check_layout("imm streamed", launches)
    return launches


class StepCount:
    """While open, the cascade module's measurement hook: counts the
    spans named ``step`` (one a diffusion step, on every route but the
    map engine, which names none: its count reads None)."""

    def __enter__(self):
        self.count = 0
        self._old, cascade._clock = cascade._clock, self
        return self

    def __call__(self, name: str):
        self.count += name == "step"
        return contextlib.nullcontext()

    def __exit__(self, *exc):
        cascade._clock = self._old


def route_label(engine: str, gather: str) -> str:
    return f"kernel {gather}" if engine == "kernel" else engine


def check_routes(label, model: str, routes: dict, launches: dict):
    """Every route of a spread gave one value, the routes that step took
    as many steps, the kernel route launched its cascade kernel a step
    and drew no plane, the plane routes launched their expansion kernel
    a step, and the plain engines launched nothing."""
    if len({r["spread"] for r in routes.values()}) != 1:
        raise AssertionError(f"{label}: the routes disagree {routes}")
    steps = {r["steps"] for name, r in routes.items() if name != "map"}
    want = {"kernel auto": "cascade_lt" if model == "LT" else "cascade_ic",
            "kernel resident": "rrr_expand_resident",
            "kernel streamed": "rrr_expand_streamed"}
    bad = [name for name, kernel in want.items()
           if launches[name][kernel] != routes[name]["steps"]
           or sum(launches[name].values()) != routes[name]["steps"]]
    bad += [name for name in ("packed", "map") if sum(launches[name].values())]
    if len(steps) != 1 or bad or routes["kernel auto"]["planes"] \
            or not routes["kernel auto"]["steps"]:
        raise AssertionError(f"{label}: steps {steps}, launches of "
                             f"{bad}: {routes}")


def engines_agree(dev) -> dict:
    """The spread at n = 3000 under IC, LT and WC: the map and packed
    engines on the CPU and every route on the card (kernel over each
    gather, packed, map) give one value.  Returns the card's WC kernel
    route's launches (set to 0 just before it)."""
    out = {}
    for model in ("IC", "LT", "WC"):
        g = {d: generators.erdos_renyi(3000, 4.0, seed=5, device=d)
             for d in ("cpu", dev)}
        seeds = torch.arange(0, 3000, 150)
        key = prng.key(5).fold_in(99)
        cpu = {eng: float(cascade.spread(g["cpu"], seeds, key, model=model,
                                         engine=eng))
               for eng in ("packed", "map")}
        card, launches = {}, {}
        for engine, gather in WC_ROUTES:
            name = route_label(engine, gather)
            ops.reset_launches()
            with StepCount() as steps, PlaneDraws() as planes:
                sp = float(cascade.spread(g[dev], seeds.to(dev), key,
                                          model=model, engine=engine,
                                          gather=gather))
                torch.cuda.synchronize()
            launches[name] = dict(ops.LAUNCHES)
            card[name] = dict(spread=sp, steps=(steps.count if engine != "map"
                                                else None),
                              planes=planes.count)
        emit(phase="paths", path="engines", model=model, cpu=cpu,
             card=card)
        if set(cpu.values()) != {card["map"]["spread"]}:
            raise AssertionError(f"{model}: the CPU's engines {cpu} != the "
                                 f"card's {card}")
        check_routes(f"{model} at n = 3000", model, card, launches)
        out[model] = launches["kernel auto"]
    return out


def wc_spread(dev, seeds) -> dict:
    """The WC spread at full size: FULL's graph, the FULL run's seeds,
    its 64 simulations and key, over every route (WC_ROUTES), each
    route's launch counts set to 0 just before it and read just after.
    Emits each route's spread, steps, seconds, peak bytes and launches;
    returns the kernel routes' launches: ``wc`` (auto), ``wc resident``
    and ``wc streamed``."""
    args = im_driver.parser().parse_args(FULL)
    g = im_driver.make_graph(args.graph, args.n, args.avg_deg, args.seed, dev)
    key = prng.key(args.seed).fold_in(99)
    seeds = torch.from_numpy(seeds)
    routes, launches = {}, {}
    for engine, gather in WC_ROUTES:
        name = route_label(engine, gather)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        with StepCount() as steps, PlaneDraws() as planes:
            t0 = time.perf_counter()
            sp = float(cascade.spread(g, seeds, key, model="WC",
                                      num_sims=args.eval_sims, engine=engine,
                                      gather=gather))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches[name] = dict(ops.LAUNCHES)
        routes[name] = dict(
            spread=sp, steps=steps.count if engine != "map" else None,
            seconds=seconds,
            planes=planes.count,
            peak_bytes=torch.cuda.max_memory_allocated(dev),
            launches={k: v for k, v in launches[name].items() if v})
    emit(phase="wc", n=g.num_vertices, edges=g.num_edges,
         sims=args.eval_sims, routes=routes)
    real = seeds[seeds >= 0]
    sp = routes["map"]["spread"]
    if not (np.isfinite(sp) and sp >= len(real)):
        raise AssertionError(f"wc: spread {sp} out of range")
    check_routes("wc", "WC", routes, launches)
    del g
    torch.cuda.empty_cache()
    return {"wc": launches["kernel auto"],
            "wc resident": launches["kernel resident"],
            "wc streamed": launches["kernel streamed"]}


def faulted_round(dev) -> dict:
    """The round of ROUND under FAULTS through ``im_driver.run`` (the lazy
    senders, then the plain ones, --solver scan), then a plan that loses
    all 8 machines.  The faulted round must keep FAULT_SURVIVORS, report
    round_survived, and give the seeds and coverage of the survivors
    merge run directly on the same rows (``randgreedi_maxcover(rows,
    fold_in(key, 2), survivors=...)``) and of the plain run; the lost
    round must return 1 with round_survived false.  Each run's launch
    counts are set to 0 just before it and read just after."""
    runs, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, argv in (("faulted lazy", FAULTED),
                            ("faulted scan", at_scale(FAULTED,
                                                      solver="scan")),
                            ("all lost", ROUND + ALL_LOST)):
            path = os.path.join(tmp, label.replace(" ", "_") + ".json")
            ops.reset_launches()
            out = im_driver.run(argv + ["--fault-report", path])
            torch.cuda.synchronize()
            launches[label] = dict(ops.LAUNCHES)
            with open(path) as f:
                report = json.load(f)
            runs[label] = (out, report)
            emit(phase="faulted", run=label, rc=out["rc"],
                 survivors=list(out["survivors"]),
                 alpha_used=out["alpha_used"], coverage=out["coverage"],
                 spread=out["spread"], theta=out["theta"],
                 straggler_flags=out["straggler_flags"],
                 seconds=dict(graph=out["graph_s"], **out["stats"]),
                 peak_bytes=out["peak_bytes"], report_pass=report["pass"],
                 checks=report["checks"],
                 events=[(e["site"], e["kind"], e["occurrence"])
                         for e in report["events"]],
                 launches={k: v for k, v in launches[label].items() if v})
    args = im_driver.parser().parse_args(ROUND)
    g = generators.erdos_renyi(args.n, args.avg_deg, args.seed, device=dev)
    nbr, prob, wt = csr.padded_adjacency(g)
    key = prng.key(args.seed)
    rows = rrr.sample_incidence(
        nbr, prob, wt, key.fold_in(1), theta=args.theta, n=args.n,
        model=args.model, sampler=args.sampler,
        fwd=csr.padded_forward_adjacency(g), coin_chunk=args.coin_chunk,
        gather=args.gather)
    lazy, lazy_report = runs["faulted lazy"]
    direct = randgreedi.randgreedi_maxcover(
        rows, key.fold_in(2), m=args.machines, k=args.k,
        alpha_trunc=lazy["alpha_used"], survivors=FAULT_SURVIVORS)
    del rows, g
    torch.cuda.empty_cache()
    want = dict(seeds=direct.seeds.cpu().tolist(),
                coverage=int(direct.coverage))
    emit(phase="faulted", run="direct survivors merge", **want)
    for label in ("faulted lazy", "faulted scan"):
        out, report = runs[label]
        got = dict(seeds=out["seeds"].tolist(), coverage=out["coverage"])
        if (out["rc"] or tuple(out["survivors"]) != FAULT_SURVIVORS
                or got != want or not report["pass"]
                or report["checks"][0]["name"] != "round_survived"):
            raise AssertionError(f"{label}: rc {out['rc']}, survivors "
                                 f"{out['survivors']}, {got} != the direct "
                                 f"merge {want}, report {report['checks']}")
        check_seeds(out["seeds"], args.n)
    if runs["faulted scan"][0]["spread"] != lazy["spread"]:
        raise AssertionError("the faulted round's spread differs by solver")
    lost, report = runs["all lost"]
    if lost["rc"] != 1 or report["pass"] or \
            report["checks"][0]["name"] != "round_survived":
        raise AssertionError(f"all lost: rc {lost['rc']}, {report}")
    solver_kernels = [k for k in ops.KERNELS
                      if k.startswith(("greedy_pick", "lazy_greedy",
                                       "topk_gain", "compact_rows"))]
    mine = launches["faulted lazy"]
    if not (mine["rrr_expand_ic"] and mine["cascade_ic"]
            and mine["lazy_greedy_compact"] + mine["lazy_greedy"]) \
            or mine["bucket_insert"] or mine["bucket_insert_stream"] \
            or any(launches["faulted scan"][k] for k in solver_kernels):
        raise AssertionError(f"the faulted rounds launched {launches}")
    return launches


def seeds_sha256(seeds) -> str:
    return hashlib.sha256(json.dumps(
        [int(x) for x in seeds]).encode()).hexdigest()[:16]


def lt_run():
    """The slice's IMM under LT at full size through ``im_driver.run``:
    sampling through rrr_expand_lt and the spread through cascade_lt,
    no plane drawn and no plane kernel launched, the results those
    recorded in ``LT_RECORDED``.  Launch counts set to 0 just before it
    and read just after."""
    ops.reset_launches()
    with PlaneDraws() as planes:
        out = im_driver.run(LT_FULL)
        torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    seeds = out["seeds"]
    got = dict(theta=out["theta"], rounds=out["rounds"],
               coverage_fraction=out["coverage_fraction"],
               spread=out["spread"], bfs_steps=out["bfs_steps"],
               seeds_sha256=seeds_sha256(seeds))
    emit(phase="lt", n=out["n"], edges=out["edges"], seconds=dict(
        graph=out["graph_s"], sample=out["sample_s"], select=out["select_s"],
        spread=out["spread_s"]), peak_bytes=out["peak_bytes"],
         planes=planes.count, launches=launches, **got)
    check_seeds(seeds, out["n"])
    if got != LT_RECORDED:
        raise AssertionError(f"lt: {got} != the recorded {LT_RECORDED}")
    missing = [k for k in LT_RUN + SLICE1[2:] if not launches[k]]
    planed = {k: launches[k] for k in ("rrr_expand_resident",
                                       "rrr_expand_streamed", "coin_pack",
                                       "rrr_expand_ic", "cascade_ic")
              if launches[k]}
    if missing or planed or planes.count:
        raise AssertionError(f"lt: never launched {missing}, launched "
                             f"{planed}, drew {planes.count} planes")
    check_layout("lt", launches)
    return launches, seeds


def check_layout(run: str, launches: dict, layout: str = "compact",
                 handovers: dict | None = None):
    """A full-size run solved its machine axis, if it has one, on
    ``layout``: the compact cells never launch a dense sweep; the dense
    (supercritical) ones launch each dense sweep after the compaction that
    counted the words, and the compact picks only after the handovers the
    wrappers reported (``handovers``, ``ops.HANDOVERS`` after the run):
    one more compaction (the residual's) and one compact launch each."""
    handovers = handovers or {}
    dense = {k: launches[k] for k in DENSE_RUN if launches[k]}
    compact = {k: launches[k + "_compact"] for k in DENSE_RUN
               if launches[k + "_compact"]}
    if layout == "compact":
        ok = not dense and not any(handovers.values())
    else:
        ok = bool(dense) and all(
            launches[k + "_compact"] == handovers.get(k, 0)
            for k in DENSE_RUN) and launches["compact_rows"] == (
                sum(dense.values()) + sum(handovers.values()))
    if not ok:
        raise AssertionError(f"{run}: the machine-axis solve took the dense "
                             f"layout {dense} and the compact one {compact}, "
                             f"{launches['compact_rows']} compactions, "
                             f"handovers {handovers}")


def supercritical_runs():
    """IMM and the lazy round on the supercritical configuration through
    ``im_driver.run``: both must solve their machine axis on the dense
    layout (and may hand over to the compact picks, as the wrappers
    report) and give the results in ``DENSE_RECORDED``.
    Each run's launch counts and handovers are set to 0 just before it
    and read just after; where its solves handed over, the pick, the
    residual and each machine's exhausted pick are
    :func:`time_dense_solve`'s, on the rows this configuration gives.  Cascades reach most of the graph, so the cover fills within
    k picks and the later picks gain 0 (seed -1).  Returns the launches
    and the IMM run's seeds."""
    launches = {}
    for run, argv in (("imm supercritical", DENSE_FULL),
                      ("round supercritical", DENSE_ROUND)):
        ops.reset_launches()
        with PlaneDraws() as planes:
            out = im_driver.run(argv)
            torch.cuda.synchronize()
        launches[run] = counts = dict(ops.LAUNCHES)
        handovers = dict(ops.HANDOVERS)
        seeds = out["seeds"]
        real = seeds[seeds >= 0]
        rnd = out.get("round")
        emit(phase="supercritical", run=run, theta=out["theta"],
             seeds=int(len(real)), spread=out["spread"], n=out["n"],
             edges=out["edges"],
             coverage_fraction=out.get("coverage_fraction"),
             coverage=rnd["coverage"] if rnd else None,
             seconds=dict(graph=out["graph_s"], **(
                 rnd["seconds"] if rnd else dict(sample=out["sample_s"],
                                                 select=out["select_s"])),
                 spread=out["spread_s"]),
             peak_bytes=out["peak_bytes"], live_planes=planes.count,
             launches=counts, handovers=handovers,
             seeds_sha256=seeds_sha256(seeds))
        if not (0 < len(real) <= 100 and len(set(real.tolist())) == len(real)
                and real.max() < out["n"] and np.isfinite(out["spread"])
                and out["spread"] >= len(real)):
            raise AssertionError(f"{run}: bad seeds {seeds} or spread "
                                 f"{out['spread']}")
        got = dict(coverage_fraction=out.get("coverage_fraction"),
                   spread=out["spread"], seeds_sha256=seeds_sha256(seeds))
        if got != DENSE_RECORDED[run]:
            raise AssertionError(f"{run}: {got} != the recorded "
                                 f"{DENSE_RECORDED[run]}")
        check_ic_sampling(run, counts)
        check_ic_spread(run, counts, planes.count)
        check_layout(run, counts, "dense", handovers)
        missing = [k for k, r in RECEIVER_RUN.items()
                   if r == run and not counts[k]]
        if missing:
            raise AssertionError(f"{run}: never launched {missing}")
        if run == "imm supercritical":
            dense_seeds = seeds
    return launches, dense_seeds


def check_ic_sampling(run: str, launches: dict):
    """A full-size run sampled IC through the fused kernel and built no
    coin plane."""
    if not launches["rrr_expand_ic"] or launches["coin_pack"]:
        raise AssertionError(f"{run}: IC sampling launched rrr_expand_ic "
                             f"{launches['rrr_expand_ic']} times and "
                             f"coin_pack {launches['coin_pack']} times")


def check_seeds(seeds, n: int, k: int = 100):
    real = seeds[seeds >= 0]
    if not (len(real) == k and len(set(real.tolist())) == k
            and real.max() < n):
        raise AssertionError(f"bad seed set {seeds}")


def round_runs(dev):
    """The fixed-theta round at full size through the driver with the
    lazy and the fused senders, then the Ripples round at the same theta
    through ``greediris.build_ripples_round``.  Each run's launch counts
    are set to 0 just before it and read just after."""
    launches, outs = {}, {}
    for solver in ("lazy", "fused"):
        argv = [solver if a == "lazy" else a for a in ROUND]
        ops.reset_launches()
        with PlaneDraws() as planes:
            out = im_driver.run(argv)
            torch.cuda.synchronize()
        launches[f"round {solver}"] = dict(ops.LAUNCHES)
        rnd = out["round"]
        emit(phase="round", solver=solver, theta=out["theta"],
             coverage=rnd["coverage"],
             global_coverage=rnd["global_coverage"],
             best_local_coverage=rnd["best_local_coverage"],
             spread=out["spread"], n=out["n"], edges=out["edges"],
             seconds=dict(graph=out["graph_s"], **rnd["seconds"],
                          spread=out["spread_s"]),
             peak_bytes=out["peak_bytes"], live_planes=planes.count,
             launches=launches[f"round {solver}"])
        check_seeds(out["seeds"], out["n"])
        check_ic_spread(f"round {solver}", launches[f"round {solver}"],
                        planes.count)
        if rnd["coverage"] < rnd["best_local_coverage"]:
            raise AssertionError("round coverage below the best local one")
        if not np.isfinite(out["spread"]):
            raise AssertionError("spread is not finite")
        outs[solver] = out
    if outs["lazy"]["seeds"].tolist() != outs["fused"]["seeds"].tolist():
        raise AssertionError("lazy and fused senders gave other seeds")

    args = im_driver.parser().parse_args(ROUND)
    g = generators.erdos_renyi(args.n, args.avg_deg, args.seed, device=dev)
    nbr, prob, wt = csr.padded_adjacency(g)
    fn, theta = greediris.build_ripples_round(
        m=args.machines, n=args.n, theta=args.theta, k=args.k,
        model=args.model, use_kernel=True, sampler="kernel",
        fwd=csr.padded_forward_adjacency(g))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    stats = {}
    ops.reset_launches()
    seeds, cov = fn(nbr, prob, wt, prng.key(args.seed), stats=stats)
    torch.cuda.synchronize()
    launches["ripples"] = dict(ops.LAUNCHES)
    emit(phase="round", path="ripples", theta=theta, coverage=int(cov),
         seconds=stats, peak_bytes=torch.cuda.max_memory_allocated(dev),
         launches=launches["ripples"])
    check_seeds(seeds.cpu().numpy(), args.n)
    missing = [k for k, run in ROUND_RUN.items() if launches[run][k] == 0]
    if missing:
        raise AssertionError(f"the round paths never launched {missing}")
    for run, counts in launches.items():
        check_ic_sampling(run, counts)
        check_layout(run, counts)
    return launches


def serve_runs(dev):
    """The serving replay at full size through ``serve.run`` with the
    resident, the fused and the lazy senders, which must give the same
    answers.  Each run's launch counts and peak
    memory are reset just before it and read just after; the launches
    returned are the replay's, read before ``--check`` replays every
    query through the sequential solver (its launches are printed
    apart).  The refreshes are split into the slab fills' sampler
    kernels (CUDA events around each kernel wrapper call), the sampler's
    tables (host clock between synchronizations) and the rest.  Returns
    the launches and the lazy run's service (its final pool is
    timed)."""
    launches, outs = {}, {}
    check = serve.check_bit_identity

    def counted_check(*args, **kwargs):
        torch.cuda.synchronize()
        replay.update(ops.LAUNCHES)
        return check(*args, **kwargs)

    for solver in ("resident", "fused", "lazy"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        replay = {}
        serve.check_bit_identity = counted_check
        try:
            with SamplerClock(dict(rrr=rrr, rrr_expand=rrr_expand,
                                   coins=coins, service=service)) as clock:
                out = serve.run(SERVE + ["--solver", solver])
                kernel_s = clock.kernel_s()
        finally:
            serve.check_bit_identity = check
        launches[f"serve {solver}"] = replay
        peak = torch.cuda.max_memory_allocated(dev)
        st = out["stats"]
        answers = out["answers"]
        emit(phase="serve", solver=solver, rc=out["rc"],
             mismatches=out["mismatches"], answers=len(answers),
             queries_per_s=len(answers) / out["elapsed_s"],
             elapsed_s=out["elapsed_s"], generations=out["generations"],
             theta=out["theta"], certified=out["certified"],
             solves=st["solves"], solve_s=st["solve_s"],
             s_per_solve=st["solve_s"] / st["solves"],
             refreshes=st["refreshes"], refresh_s=st["refresh_s"],
             s_per_refresh=st["refresh_s"] / st["refreshes"],
             refresh_split=dict(sampler_kernels_s=kernel_s,
                                sampler_calls=len(clock.events),
                                tables_s=clock.tables_s,
                                rest_s=st["refresh_s"] - kernel_s
                                - clock.tables_s),
             k_used=[a.k_used for a in answers], peak_bytes=peak,
             launches=replay, check_launches={
                 k: v - replay[k] for k, v in ops.LAUNCHES.items()
                 if v - replay[k]})
        if out["rc"] or out["mismatches"]:
            raise AssertionError(f"serve {solver}: --check failed")
        if peak >= SERVE_PEAK_LIMIT:
            raise AssertionError(f"serve {solver}: peak {peak} bytes")
        for a in answers:
            real = a.seeds[a.seeds >= 0]
            if not (len(real) == a.k_used and len(set(real.tolist())) == len(real)
                    and (real < 262144).all() and a.coverage > 0
                    and np.isfinite(a.sigma_lower) and np.isfinite(a.sigma_upper)):
                raise AssertionError(f"serve {solver}: bad answer {a}")
        if solver != "lazy":
            del out["service"]              # free its pools before the next
        outs[solver] = out
    for solver in ("fused", "lazy"):
        want, got = outs["resident"]["answers"], outs[solver]["answers"]
        if len(got) != len(want) or not all(
                serve.answers_equal(a, b) for a, b in zip(want, got)):
            raise AssertionError(f"serve: resident and {solver} answers "
                                 "differ")
    missing = [k for k, run in SERVE_RUN.items() if launches[run][k] == 0]
    if missing:
        raise AssertionError(f"the serving path never launched {missing}")
    for run, counts in launches.items():
        check_ic_sampling(run, counts)
    return launches, outs["lazy"]["service"], outs["lazy"]["trace"]


# ---------------------------------------------------------------- phase 6

def bound(bytes_, ops_=0.0, words=0, nonzero=0):
    """(bound_ms, bound_by, int_ops): the larger of bytes over the HBM
    rate and integer ops over the INT32 rate.  ``ops_`` counts other
    integer ops, ``words`` the gain words (an and-not each), ``nonzero``
    those of them that are not zero (a popcount and an add each)."""
    ops_ += GAIN_OPS_PER_WORD * words + GAIN_OPS_PER_NONZERO_WORD * nonzero
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", ops_)


def timed(name, kernel_fn, plain_fn, reps, plain_reps, bytes_, ops_=0.0,
          words=0, nonzero=0, hide_host=False):
    """Kernel vs plain on the same main-path inputs: equality, medians,
    and the bound (:func:`bound`).  ``bytes_``, ``ops_``, ``words`` and
    ``nonzero`` may be callables, read once the plain version has run.
    ``plain_reps=0`` times the parity call of a slow plain version,
    once; ``hide_host`` times the kernel's device span alone
    (:func:`median_ms`)."""
    got = kernel_fn()
    if plain_reps:
        err = max_err(got, plain_fn())
    else:
        want, plain_once = once(plain_fn)
        err = max_err(got, want)
        del want
    del got
    if err:
        raise AssertionError(f"{name}: kernel != plain at main-path shapes")
    bytes_, ops_, words, nonzero = (x() if callable(x) else x for x in (
        bytes_, ops_, words, nonzero))
    bound_ms, bound_by, ops_ = bound(bytes_, ops_, words, nonzero)
    row = dict(name=name, route="cuda", source=SOURCES[name][0],
               replaces=SOURCES[name][1], max_abs_err=err,
               ms=median_ms(kernel_fn, reps, hide_host=hide_host),
               plain_ms=(median_ms(plain_fn, plain_reps) if plain_reps
                         else plain_once),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    torch.cuda.empty_cache()
    emit(phase="timing", bytes=bytes_, int_ops=ops_, nonzero_words=nonzero,
         **row)
    return row


def time_machine_solve(name, rows, k, ex) -> dict:
    """Row 3 (``greedy_pick``, the resident solve) or row 6
    (``lazy_greedy``) of the kernel table at one machine-axis shape: the
    solve as the wrapper runs it (the list, one 8-byte read of its
    count, the picks of the layout it chose), and each of its kernels
    against its
    plain version — the compaction (the lists as sets per row), the
    compact picks on that list and the dense sweep forced to the end (cap
    0: no handover).  Bounds: the
    solve's, restated (the rows read once and the outputs written once;
    an and-not for each list entry and a popcount and an add for each
    non-zero gain word that an exact lazy schedule needs), with the
    older bound beside it (the rows of the tiles that schedule needs);
    the picks' own (the list read once, the outputs
    written once, the same operations); the compaction's (the rows read
    once, the list written once).  Returns the JSON rows of
    ``compact_rows``, NAME_compact and NAME (the dense sweep)."""
    lazy = name == "lazy_greedy"
    m, n, w = rows.shape
    wrapper, dense, compact, compact_plain = (
        (lazy_greedy.greedy_maxcover_lazy, lazy_greedy.lazy_dense,
         lazy_greedy.lazy_compact, lazy_greedy.lazy_compact_plain) if lazy
        else (greedy_pick.greedy_maxcover_resident, greedy_pick.greedy_dense,
              greedy_pick.greedy_compact, greedy_pick.greedy_compact_plain))
    need = {}
    want, dense_plain_ms = once(lambda: lazy_greedy.lazy_plain(
        rows, k, ex, stats=need)[:4])
    errs = {}
    if not lazy:
        plain, dense_plain_ms = once(lambda: greedy_pick.greedy_plain(
            rows, k, ex))
        errs["plain"] = max_err(plain, want)
        del plain
    stats = {}
    got = wrapper(rows, k, ex, stats=stats)
    if stats["layout"] != "compact":
        raise AssertionError(f"{name}: the full-size rows took the "
                             f"{stats['layout']} layout")
    errs["solve"] = max_err(got[:4], want)
    lists = greedy_pick.row_lists(rows)
    plain_lists, compact_plain_ms = once(
        lambda: greedy_pick.compact_rows_plain(rows))
    errs["compact_rows"] = max_err(greedy_pick.canonical_lists(lists),
                                   greedy_pick.canonical_lists(plain_lists))
    del plain_lists
    got_c = compact(rows, k, ex, lists)
    want_c, picks_plain_ms = once(lambda: compact_plain(rows, k, ex, lists))
    errs["picks"] = max(max_err(got_c[:4], want), max_err(got_c[:4],
                                                          want_c[:4]))
    got_d = dense(rows, k, ex, cap=0)
    errs["dense"] = max_err(got_d[:4], want)
    swept = {}
    if lazy:
        for label, g in (("wrapper", got), ("compact", got_c),
                         ("dense", got_d)):
            check_swept(name, g[4], n, k)
            swept[label] = g[4].tolist()
    del got, got_c, want_c, got_d
    if any(errs.values()):
        raise AssertionError(f"{name}: kernel != plain at main-path shapes "
                             f"{errs}")
    compact_ms = median_ms(lambda: greedy_pick.compact_rows_launch(
        rows, lists.nonzero_words), 10, hide_host=True)
    picks_ms = median_ms(lambda: compact(rows, k, ex, lists), 10,
                         hide_host=True)
    solve_ms = median_ms(lambda: wrapper(rows, k, ex), 10)
    dense_ms = median_ms(lambda: dense(rows, k, ex, cap=0), 5)

    listed_rows = int(lists.listed.sum())
    tiles = lazy_greedy.num_row_tiles(n)
    out_bytes = 4 * (m * k * w + m * w + 2 * m * k + (m if lazy else 0))
    list_bytes = (8 * lists.nonzero_words + 16 * listed_rows + 8 * m * tiles
                  + 4 * m)
    work = dict(words=need["entries_needed"],
                nonzero=need["nonzero_words_needed"])
    solve_bound, solve_by, solve_ops = bound(4 * rows.numel() + out_bytes,
                                             **work)
    picks_bound, picks_by, _ = bound(list_bytes + out_bytes, **work)
    compact_bound, compact_by, _ = bound(4 * rows.numel() + list_bytes)
    needed_rows = min(int(need["tiles_needed"].sum()) * lazy_greedy.TILE_ROWS,
                      k * m * n)
    old_bound, old_by, _ = bound(4 * needed_rows * w + out_bytes,
                                 words=needed_rows * w,
                                 nonzero=need["nonzero_words_needed"])
    shape = dict(rows_shape=[m, n, w], k=k, nonzero_words=lists.nonzero_words,
                 listed_rows=listed_rows)
    solve = dict(solve_ms=solve_ms, layout=stats["layout"], compact_ms=compact_ms,
                 picks_ms=picks_ms, dense_ms=dense_ms,
                 solve_bound_ms=solve_bound, solve_bound_by=solve_by,
                 solve_int_ops=solve_ops, old_bound_ms=old_bound,
                 old_bound_by=old_by, share=solve_bound / solve_ms,
                 tiles_needed=need["tiles_needed"].tolist(), num_tiles=tiles,
                 entries_needed=need["entries_needed"],
                 nonzero_words_needed=need["nonzero_words_needed"])
    if lazy:
        solve["tiles_swept"] = swept

    def row(kernel, ms, plain_ms, bound_ms, bound_by, err, **extra):
        r = dict(name=kernel, route="cuda", source=SOURCES[kernel][0],
                 replaces=SOURCES[kernel][1], max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=None, **shape, **extra)
        emit(phase="timing", **r)
        return r
    return {
        "compact_rows": row("compact_rows", compact_ms, compact_plain_ms,
                            compact_bound, compact_by, errs["compact_rows"],
                            solve=name, list_bytes=list_bytes),
        name + "_compact": row(name + "_compact", picks_ms, picks_plain_ms,
                               picks_bound, picks_by, errs["picks"],
                               per_pick_us=picks_ms / k * 1e3, **solve),
        name: row(name, dense_ms, dense_plain_ms, solve_bound, solve_by,
                  errs["dense"], old_bound_ms=old_bound,
                  sweep_bytes=4 * k * rows.numel() if not lazy else None,
                  via="forced: the dense sweep on the same rows, cap 0")}


def residual_by_pick(rows, ex, out, picks: int = 6) -> list:
    """Each machine's residual words (``greedy_pick.residual_words``)
    before each of the first ``picks`` picks of the solve ``out``: [pick]
    [machine]."""
    m, n, _ = rows.shape
    taken = greedy_pick.start(rows, 1, ex).taken
    cov = torch.zeros_like(out[2])
    counts = []
    for p in range(min(picks, out[0].shape[1])):
        counts.append(greedy_pick.residual_words(rows, cov, taken).tolist())
        cov |= out[1][:, p]
        seed = out[0][:, p].long()
        taken[torch.arange(m, device=rows.device), seed.clamp(min=0)] |= (
            seed >= 0)
    return counts


def time_dense_solve(name, rows, k, ex, run: str) -> tuple:
    """Row 3 (``greedy_pick``) or row 6 (``lazy_greedy``) of the kernel
    table on the rows the supercritical ``run`` gives it, which must take
    the dense layout: the dense solve as it runs (the row's time: the
    dense kernel until its handover, the 8-byte tally read, the
    residual's compaction and count read, the compact picks), the dense
    launch alone with its tally read (``dense_ms``), the dense sweep
    forced to the end (cap 0: no handover, it still stops where the gains
    run out), the wrapper's whole solve (the count that chose the layout
    first, ``solve_ms``) and the compact layout forced from pick 0, each
    held against the plain solve.  Records the handover, the residual
    counted at each swept pick (the forced sweep's), each machine's
    residual before picks 0-5 and its pick at which the gains ran out.
    Bound: :func:`time_machine_solve`'s restated one.  Returns the row
    and the handover's parts (:func:`time_handover`) as ``shapes``
    entries of ``compact_rows`` and NAME_compact."""
    lazy = name == "lazy_greedy"
    m, n, w = rows.shape
    wrapper, dense, compact, picks = (
        (lazy_greedy.greedy_maxcover_lazy, lazy_greedy.lazy_dense,
         lazy_greedy.lazy_compact, lazy_greedy.lazy_dense_picks) if lazy
        else (greedy_pick.greedy_maxcover_resident, greedy_pick.greedy_dense,
              greedy_pick.greedy_compact, greedy_pick.dense_picks))
    need = {}
    want, plain_ms = once(lambda: lazy_greedy.lazy_plain(
        rows, k, ex, stats=need)[:4])
    errs = {}
    if not lazy:
        plain, plain_ms = once(lambda: greedy_pick.greedy_plain(rows, k, ex))
        errs["plain"] = max_err(plain, want)
        del plain
    stats = {}
    got = wrapper(rows, k, ex, stats=stats)
    if stats["layout"] != "dense":
        raise AssertionError(f"{name}: the supercritical rows took the "
                             f"{stats['layout']} layout")
    count = stats["nonzero_words"]
    swept_stats, full_stats = {}, {}
    got_d = dense(rows, k, ex, stats=swept_stats)
    got_f = dense(rows, k, ex, cap=0, stats=full_stats)
    got_c = compact(rows, k, ex, full_list(rows, count))
    errs.update(solve=max_err(got[:4], want), dense=max_err(got_d[:4], want),
                full_sweep=max_err(got_f[:4], want),
                compact=max_err(got_c[:4], want))
    swept = {}
    if lazy:
        for label, g in (("wrapper", got), ("dense", got_d),
                         ("full sweep", got_f), ("compact", got_c)):
            check_swept(name, g[4], n, k)
            swept[label] = g[4].tolist()
    real = int((got[0] >= 0).sum())
    exhausted = (got[3] > 0).sum(1).tolist()
    by_pick = residual_by_pick(rows, ex, got)
    del got, got_d, got_f, got_c
    if any(errs.values()):
        raise AssertionError(f"{name}: kernel != plain at the supercritical "
                             f"shape {errs}")
    if swept_stats["handover_pick"] is None:
        raise AssertionError(f"{name}: the supercritical solve never handed "
                             f"over {swept_stats}")
    cap = greedy_pick.list_room(m, n, w)
    out_bytes = 4 * (m * k * w + m * w + 2 * m * k + (m if lazy else 0))
    bound_ms, bound_by, int_ops = bound(
        4 * rows.numel() + out_bytes, words=need["entries_needed"],
        nonzero=need["nonzero_words_needed"])
    ms = median_ms(lambda: dense(rows, k, ex), 5)
    full_ms = median_ms(lambda: dense(rows, k, ex, cap=0), 5)
    r = dict(name=name, route="cuda", source=SOURCES[name][0],
             replaces=SOURCES[name][1], max_abs_err=max(errs.values()),
             ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
             library_ms=None, rows_shape=[m, n, w], k=k,
             seeds_per_machine=real / m, layout=stats["layout"],
             nonzero_words=count, listed_rows=stats["listed_rows"],
             int_ops=int_ops, full_sweep_ms=full_ms,
             dense_ms=median_ms(lambda: picks(rows, k, ex, cap), 5),
             handover_pick=swept_stats["handover_pick"],
             handover_residual=swept_stats["residual"][-1],
             handover_cap=cap, residual=full_stats["residual"],
             spent_pick=full_stats["spent_pick"],
             exhausted_pick=exhausted, residual_by_pick=by_pick,
             solve_ms=median_ms(lambda: wrapper(rows, k, ex), 5),
             compact_forced_ms=median_ms(lambda: compact(
                 rows, k, ex, full_list(rows, count)), 3),
             entries_needed=need["entries_needed"],
             nonzero_words_needed=need["nonzero_words_needed"],
             **({"tiles_swept": swept} if lazy else {}))
    r["share"] = bound_ms / r["ms"]
    r["full_sweep_share"] = bound_ms / full_ms
    emit(phase="timing", input="supercritical", run=run, **r)
    return r, time_handover(name, rows, k, ex, cap, run)


def time_handover(name, rows, k, ex, cap: int, run: str) -> dict:
    """The parts of a dense solve after its handover, on the state the
    dense kernel (``name``) leaves at room ``cap``: the residual's masked
    compaction (``compact_rows`` with the cover and the taken rows, its
    device span) and the compact picks from the handover state (their
    device span, the state restored before each call), each against its
    plain version from the same state (the list as sets per row; the
    picks' outputs).  Bounds: the compaction reads the rows, the cover
    and the taken flags once and writes the list once; the picks read the
    list and the state once and write the outputs once, with an and-not,
    a popcount and an add for each entry (one sweep of the list).
    Returns ``{"compact_rows": row, NAME_compact: row}``, each to go under
    ``f"{run} handover"`` in its kernel's ``shapes``."""
    lazy = name == "lazy_greedy"
    m, n, w = rows.shape
    tiles = lazy_greedy.num_row_tiles(n)
    handed = (lazy_greedy.lazy_dense_picks if lazy
              else greedy_pick.dense_picks)(rows, k, ex, cap)
    state = handed[0] if lazy else handed
    cov, taken = state.out[2], state.taken
    lists = greedy_pick.residual_lists(rows, state, cap)
    plain_lists, compact_plain_ms = once(
        lambda: greedy_pick.compact_rows_plain(rows, cov, taken))
    errs = {"compact_rows": max_err(
        greedy_pick.canonical_lists(lists),
        greedy_pick.canonical_lists(plain_lists))}
    del plain_lists

    def fresh():
        copy = state._replace(out=tuple(o.clone() for o in state.out),
                              taken=state.taken.clone())
        return (copy, handed[1].clone(), handed[2].clone()) if lazy else (
            copy,)
    compact, compact_plain = (
        (lazy_greedy.lazy_compact, lazy_greedy.lazy_compact_plain) if lazy
        else (greedy_pick.greedy_compact, greedy_pick.greedy_compact_plain))
    got = compact(rows, k, ex, lists, *fresh())
    want, picks_plain_ms = once(lambda: compact_plain(rows, k, ex, lists,
                                                      *fresh()))
    errs["picks"] = max_err(got[:4], want[:4])
    if lazy:
        check_swept(name + "_compact", got[4], n, k)
    del got, want
    if any(errs.values()):
        raise AssertionError(f"{name}: the handover's kernels != their "
                             f"plain versions {errs}")
    arg = {}
    compact_ms = median_ms(lambda: greedy_pick.compact_rows_launch(
        rows, cap, cov, taken), 10, hide_host=True)
    picks_ms = median_ms(lambda: compact(rows, k, ex, lists, *arg["state"]),
                         10, setup=lambda: arg.update(state=fresh()),
                         hide_host=True)
    listed_rows = int(lists.listed.sum())
    entries = lists.nonzero_words
    list_bytes = 8 * entries + 16 * listed_rows + 8 * m * tiles + 4 * m
    state_bytes = 4 * (m * k * w + m * w + 2 * m * k) + m * n + (
        4 * m * tiles + 4 * m if lazy else 0)
    compact_bound, compact_by, _ = bound(
        4 * rows.numel() + 4 * m * w + m * n + list_bytes)
    picks_bound, picks_by, picks_ops = bound(
        list_bytes + 2 * state_bytes, words=entries, nonzero=entries)
    shape = dict(rows_shape=[m, n, w], k=k, handover_pick=state.p0,
                 residual=state.residual[-1], cap=cap,
                 nonzero_words=entries, listed_rows=listed_rows)

    def row(kernel, ms, plain_ms, bound_ms, bound_by, err, **extra):
        r = dict(name=kernel, route="cuda", source=SOURCES[kernel][0],
                 replaces=SOURCES[kernel][1], max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=None, **shape, **extra)
        emit(phase="timing", input=f"{run} handover", **r)
        return r
    return {
        "compact_rows": row("compact_rows", compact_ms, compact_plain_ms,
                            compact_bound, compact_by, errs["compact_rows"],
                            solve=name, masked=True, list_bytes=list_bytes),
        name + "_compact": row(
            name + "_compact", picks_ms, picks_plain_ms, picks_bound,
            picks_by, errs["picks"], from_pick=state.p0, int_ops=picks_ops,
            per_pick_us=picks_ms / (k - state.p0) * 1e3)}


def time_receiver(name, ids, rows, st, label) -> dict:
    """Row 4 (``bucket_insert``, ids [C]) or row 5
    (``bucket_insert_stream``, ids [R, C]) at one receiver input: the
    wrapper's launch against the scan, its device time (``ms``, the
    host's queueing hidden) and the wrapper's (``wrapper_ms``, the
    host's queueing in the span), and the launch's figures held against
    the grouped walk at its group (``tools/time_receiver.py``'s
    :func:`summary`: the passes on the critical path beside their
    ceiling, the accepts per bucket, the candidate at which the last
    bucket filled, the bytes read and staged).  Bound: the stream read once and the bucket state
    read and written once (bytes); the passes stand beside it."""
    stream = ids.dim() == 2
    wrapper, plain = (
        (bucket_insert.bucket_insert_stream,
         bucket_insert.bucket_insert_stream_plain) if stream
        else (bucket_insert.bucket_insert_chunk,
              bucket_insert.bucket_insert_plain))
    b, w = st.covers.shape
    k = st.seeds.shape[1]
    row = timed(name, lambda: wrapper(ids, rows, *st),
                lambda: plain(ids, rows, *st), 10, 3,
                bytes_=4 * (ids.numel() * (w + 1) + 2 * b * w + 2 * b
                            + 2 * b * k + b), hide_host=True)
    *got, stats = bucket_insert.bucket_insert_with_stats(ids, rows, *st)
    *walk, walk_stats = bucket_insert.bucket_insert_grouped_plain(
        ids, rows, *st, group=bucket_insert.GROUP)
    err = max_err(got, walk)
    if err or not torch.equal(stats[:, :4].cpu(), walk_stats):
        raise AssertionError(f"{name} ({label}): the launch's walk differs "
                             "from the grouped plain walk")
    figures = summary(ids, rows, st, got[1], stats)
    row.update(figures, input=label, candidates=ids.numel(), W=w, B=b,
               max_abs_err=max(row["max_abs_err"], err),
               wrapper_ms=median_ms(lambda: wrapper(ids, rows, *st), 10))
    emit(phase="receiver", name=name, input=label, ms=row["ms"],
         wrapper_ms=row["wrapper_ms"], bound_ms=row["bound_ms"], **figures)
    return row


def supercritical_timings(dev) -> dict:
    """Rows 3, 4, 5 and 6 at the shapes the supercritical runs give them:
    the IMM selector's local rows of a 32,768-sample draw (as
    :func:`main_path_timings`) for ``greedy_pick`` and, from its local
    solves, the chunk for ``bucket_insert``; the round's shuffled rows
    for ``lazy_greedy`` and, from its lazy senders, the stream for
    ``bucket_insert_stream``.  Returns those rows, and under
    ``"handover"`` the handovers' parts (:func:`time_handover`) as
    ``{kernel: {f"{run} handover": row}}``."""
    args = im_driver.parser().parse_args(DENSE_FULL)
    n, m, k = args.n, args.machines, args.k
    g = generators.erdos_renyi(n, args.avg_deg, args.seed, device=dev)
    nbr, prob, wt = csr.padded_adjacency(g)
    fwd = csr.padded_forward_adjacency(g)
    incidence = rrr.sample_incidence(
        nbr, prob, wt, prng.key(args.seed).fold_in(1), theta=args.max_theta,
        n=n, model="IC", fwd=fwd)
    perm = prng.key(args.seed).fold_in(0xC0FFEE).fold_in(1).permutation(
        n, device=dev)
    assign = perm[:(n // m) * m].reshape(m, n // m).long()
    local_rows = incidence[assign].contiguous()
    del incidence
    ex = greedy_pick.excluded_ids(None, m, dev)
    handover = {}

    def dense_row(name, rows):
        run = DENSE_RUN[name]
        row, parts = time_dense_solve(name, rows, k, ex, run)
        for kernel, part in parts.items():
            handover.setdefault(kernel, {})[f"{run} handover"] = part
        return row
    out = {"greedy_pick": dense_row("greedy_pick", local_rows),
           "bucket_insert": time_receiver(
               "bucket_insert", *imm_chunk(local_rows, assign, dev),
               "imm supercritical")}
    del local_rows
    rargs = im_driver.parser().parse_args(DENSE_ROUND)
    fn, _, _ = greediris.build_round(
        m=rargs.machines, n=n, theta=rargs.theta, k=k, max_degree=0,
        model=rargs.model, sampler="kernel", fwd=fwd)
    x_s, perm = fn.sample_shuffle(nbr, prob, wt, prng.key(rargs.seed))
    out["lazy_greedy"] = dense_row("lazy_greedy", x_s)
    out["bucket_insert_stream"] = time_receiver(
        "bucket_insert_stream", *round_stream(x_s, perm, dev),
        "round supercritical")
    out["handover"] = handover
    return out


def coins_needed(t, frontier) -> int:
    """The coins of one IC step: each set frontier bit of a vertex times
    its reverse slots with p > 0."""
    live_bits = bitset.popcount(frontier).sum(1, dtype=torch.int64)
    return int((live_bits * (t.prob_p > 0).sum(1)).sum())


def push_work(t, frontier, keys, appended: int) -> dict:
    """What one IC step's data needs, for either design: the live
    frontier words (each read once, and its list entry), the valid
    reverse slots behind them (nbr and prob_p, 8 B a slot), the hit
    words (words that some fired coin reaches: visited and the next
    plane read, modified and written, 16 B each), the appended entries
    (4 B each) and the coins (OPS_PER_COIN each)."""
    live = frontier != 0
    in_deg = (t.nbr >= 0).sum(1)
    # the words a coin reaches: the step's new frontier over an empty
    # visited set
    hits = rrr_expand.rrr_expand_step_ic(frontier, torch.zeros_like(frontier),
                                         t.nbr, t.prob_p, keys, t.chunk)[0]
    work = dict(live_words=int(live.sum()),
                live_slots=int((live.sum(1) * in_deg).sum()),
                hit_words=int((hits != 0).sum()), appended=appended,
                coins=coins_needed(t, frontier))
    del hits
    work["bytes"] = (8 * work["live_words"] + 8 * work["live_slots"]
                     + 16 * work["hit_words"] + 4 * appended)
    return work


def ic_first_step(t, key, theta: int, dev):
    """The first BFS step of a ``theta``-sample draw: the roots' frontier,
    visited and the step's chunk keys, derived as the sampler does."""
    kr, kb = key.split()
    frontier = rrr.packed_roots(kr.randint((theta,), 0, t.n, device=dev),
                                t.n)
    sub = kb.split()[1]
    return frontier, frontier.clone(), [sub.fold_in(c)
                                        for c in range(t.n_chunks)]


def time_ic_step(t, frontier, visited, keys, label: str, reps: int = 10,
                 plain_reps: int = 3, plane=None, composed=True) -> dict:
    """rrr_expand_ic on one step's inputs.  The step as the sampler runs
    it (the list in, visited updated in place; inputs restored before
    each run, untimed) against its plain version — ``ms`` its device
    time, ``call_ms`` the wrapper call's span with the host's share in
    it — and the dense entry point (which adds listing the live words,
    two clones and a zero plane) against the step and, with
    ``composed``, against the composed coin_pack + rrr_expand_resident
    route.  Bound: the larger
    of :func:`push_work`'s bytes over the HBM rate and its coins'
    operations over the INT32 rate — the same yardstick for the pull
    and the push.  ``plain_reps=0`` times the plain version once."""
    n, w = frontier.shape
    kernel, plain = push_pair(t, frontier, visited, keys)
    err = max_err(kernel, plain)
    check_push(kernel, label)
    appended = kernel[2].numel()
    del kernel, plain
    entry = rrr_expand.rrr_expand_step_ic(frontier, visited, t.nbr,
                                          t.prob_p, keys, t.chunk)
    composed_err = None
    if composed:
        if plane is None:
            plane = coins.coin_plane(keys, t.prob_p, frontier, t.chunk
                                     ).reshape(t.n * t.d_pad, -1)
        composed_err = max_err(entry, rrr_expand.rrr_expand_step_resident(
            frontier, visited, t.nbr_c, t.gidx, plane))
    del plane, entry
    if err or composed_err:
        raise AssertionError(f"rrr_expand_ic: kernel != plain ({err}) or "
                             f"entry point != composed ({composed_err}) "
                             f"at {label}")
    work = push_work(t, frontier, keys, appended)
    bound_ms, bound_by, ops_ = bound(work["bytes"],
                                     OPS_PER_COIN * work["coins"])
    words = rrr_expand.live_words(frontier)
    f, vis, nxt = (torch.empty_like(frontier) for _ in range(3))
    listed = torch.empty(n * w, dtype=torch.int32, device=frontier.device)
    count = torch.zeros(1, dtype=torch.int32, device=frontier.device)

    def restore():
        f.copy_(frontier)
        vis.copy_(visited)
        nxt.zero_()

    def step(fn):
        return lambda: fn(words, f, vis, t.nbr, t.prob_p, keys, t.chunk,
                          nxt, listed, count)

    ms = median_ms(step(rrr_expand.rrr_expand_push_ic), reps, restore,
                   hide_host=True)
    call_ms = median_ms(step(rrr_expand.rrr_expand_push_ic), reps, restore)
    if plain_reps:
        plain_ms = median_ms(step(rrr_expand.expand_step_ic_push_plain),
                             plain_reps, restore)
    else:
        restore()
        plain_ms = once(step(rrr_expand.expand_step_ic_push_plain))[1]
    del f, vis, nxt, listed
    entry_ms = median_ms(lambda: rrr_expand.rrr_expand_step_ic(
        frontier, visited, t.nbr, t.prob_p, keys, t.chunk), reps)
    torch.cuda.empty_cache()
    row = dict(name="rrr_expand_ic", route="cuda",
               source=SOURCES["rrr_expand_ic"][0],
               replaces=SOURCES["rrr_expand_ic"][1], max_abs_err=err,
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None)
    extra = dict(shape=label, W=w, call_ms=call_ms, entry_ms=entry_ms,
                 int_ops=ops_,
                 composed_err=composed_err, **work)
    emit(phase="timing", **row, **extra)
    row.update(extra)
    return row


def ic_timings(t, key, first, dev) -> dict:
    """rrr_expand_ic beyond the IMM first step (``first``: its frontier,
    visited and keys): the IMM draw's densest later step, the first
    steps of the round's per-machine draw and of a serve slab, and two
    frontiers at the serve slab's shape with the same expected number of
    coins, one set bit in every word or all 32 bits in a 32nd of the
    words."""
    shapes = {}
    frontier, visited, _ = first
    step_key, best = key.split()[1], None
    for step in range(64):
        step_key, sub = step_key.split()
        keys = [sub.fold_in(c) for c in range(t.n_chunks)]
        if step and (best is None or coins_needed(t, frontier) > best[0]):
            best = (coins_needed(t, frontier), step + 1, frontier, visited,
                    keys)
        frontier, visited = rrr_expand.rrr_expand_step_ic(
            frontier, visited, t.nbr, t.prob_p, keys, t.chunk)
        if not bool(frontier.any()):
            break
    del frontier, visited
    if best is not None:
        shapes["imm late step"] = time_ic_step(t, *best[2:], "imm late step")
        shapes["imm late step"]["step"] = best[1]
    del best
    for label, theta in (("round", 131072 // 8), ("serve", 4096)):
        shapes[label] = time_ic_step(t, *ic_first_step(t, key, theta, dev),
                                     label)
    n, w = t.n, 128
    gen = torch.Generator().manual_seed(17)
    one_bit = (1 << torch.randint(0, 32, (n, w), generator=gen)).to(dev)
    full = torch.where(torch.rand((n, w), generator=gen) < 1 / 32, -1, 0)
    keys = ic_first_step(t, key, 32 * w, dev)[2]
    for label, f in (("one bit a word", bitset.to_words(one_bit)),
                     ("full words", full.to(torch.int32).to(dev))):
        shapes[label] = time_ic_step(t, f, torch.zeros_like(f), keys, label,
                                     plain_reps=0)
    return shapes


def rmat_ic_timing(dev) -> dict:
    """rrr_expand_ic at the first step of a 32,768-sample draw on the
    rmat graph of the IMM command's size (``--graph rmat``: n = 262,144,
    ~1.05M edges; reverse rows of up to ~7,600 slots, and hub targets),
    held against its plain version.  The pull's forward table would be
    as wide and the composed route's coin plane n x d_pad x W words, so
    neither is run here."""
    args = im_driver.parser().parse_args(FULL)
    g = im_driver.make_graph("rmat", args.n, args.avg_deg, args.seed, dev)
    nbr, prob, _ = csr.padded_adjacency(g)
    t = rrr._Tables(nbr, prob, None, None, None, model="IC",
                    coin_chunk=args.coin_chunk, forward=False)
    del prob
    row = time_ic_step(t, *ic_first_step(t, prng.key(args.seed).fold_in(1),
                                         args.max_theta, dev),
                       "rmat", plain_reps=1, composed=False)
    row.update(n=g.num_vertices, edges=g.num_edges, d=t.d)
    del t, nbr
    torch.cuda.empty_cache()
    return row


def choice_reads(slots, draws_v) -> int:
    """The cumulative weights that ``draws_v[v]`` LT choices on each row
    must read, each once: a binary search's ceil(log2(slots)) + 1 a
    draw, at most the row's slots (the push's rows: the in-degree; the
    cascade's: a non-decreasing row's in-degree, a marked row's d)."""
    slots = slots.long()
    per_draw = torch.log2(slots.clamp(min=1).double()).ceil().long() + 1
    per_v = torch.minimum(draws_v * per_draw, slots)
    return int(torch.where(draws_v > 0, per_v, 0).sum())


def lt_push_work(t, frontier, key, appended: int) -> dict:
    """What one LT sampling step's data needs: the live frontier words
    (each read once, and its list entry), the two row offsets of each
    vertex with a live word (8 B), the cumulative weights its choices
    read (:func:`choice_reads`), the src entry of each edge
    taken (4 B; counted as the bits the step sets over an empty visited
    plane), the hit words (visited and the next plane read, modified and
    written, 16 B each), the appended entries (4 B each) and one draw a
    live bit (OPS_PER_COIN each)."""
    bits_v = bitset.popcount(frontier).sum(1, dtype=torch.int64)
    cumw_reads = choice_reads(t.lt.indptr[1:] - t.lt.indptr[:-1], bits_v)
    hits = rrr_expand.rrr_expand_step_lt(frontier, torch.zeros_like(frontier),
                                         t.lt.indptr, t.lt.src, t.lt.cumw,
                                         key)[0]
    work = dict(live_words=int((frontier != 0).sum()),
                live_rows=int((bits_v > 0).sum()), cumw_reads=cumw_reads,
                edges=int(bitset.popcount(hits).sum(dtype=torch.int64)),
                hit_words=int((hits != 0).sum()), appended=appended,
                coins=int(bits_v.sum()))
    del hits
    work["bytes"] = (8 * work["live_words"] + 8 * work["live_rows"]
                     + 4 * cumw_reads + 4 * work["edges"]
                     + 16 * work["hit_words"] + 4 * appended)
    return work


def time_lt_step(t, frontier, visited, key, label: str, reps: int = 10,
                 plain_reps: int = 3, composed: bool = True) -> dict:
    """rrr_expand_lt on one step's inputs, as :func:`time_ic_step` times
    rrr_expand_ic: the step as the sampler runs it (device time ``ms``,
    the wrapper call's span ``call_ms``) against its plain version, the
    dense entry point, and — with ``composed`` — the route it replaced on
    the same inputs: the selection plane (``rrr._lt_mask``, ``plane_ms``)
    and rrr_expand_resident over it, together ``parent_ms``.  Bound: the
    larger of :func:`lt_push_work`'s bytes over the HBM rate and its
    draws' operations over the INT32 rate."""
    n, w = frontier.shape
    kernel, plain = lt_push_pair(t, frontier, visited, key)
    err = max_err(kernel, plain)
    check_push(kernel, label, "rrr_expand_lt")
    appended = kernel[2].numel()
    del kernel, plain
    entry = rrr_expand.rrr_expand_step_lt(frontier, visited, t.lt.indptr,
                                          t.lt.src, t.lt.cumw, key)
    extra = dict(shape=label, n=n, d=t.d, W=w)
    if composed:
        def parent():
            plane = rrr._lt_mask(t, key, frontier).reshape(n * t.d_pad, -1)
            return rrr_expand.rrr_expand_step_resident(
                frontier, visited, t.nbr_c, t.gidx, plane)
        extra["composed_err"] = max_err(entry, parent())
        extra["plane_ms"] = median_ms(lambda: rrr._lt_mask(t, key, frontier),
                                      3)
        extra["parent_ms"] = median_ms(parent, 3)
        torch.cuda.empty_cache()
    del entry
    if err or extra.get("composed_err"):
        raise AssertionError(f"rrr_expand_lt: kernel != plain ({err}) or "
                             f"entry point != the plane route "
                             f"({extra.get('composed_err')}) at {label}")
    work = lt_push_work(t, frontier, key, appended)
    bound_ms, bound_by, ops_ = bound(work["bytes"],
                                     OPS_PER_COIN * work["coins"])
    words = rrr_expand.live_words(frontier)
    f, vis, nxt = (torch.empty_like(frontier) for _ in range(3))
    listed = torch.empty(n * w, dtype=torch.int32, device=frontier.device)
    count = torch.zeros(1, dtype=torch.int32, device=frontier.device)

    def restore():
        f.copy_(frontier)
        vis.copy_(visited)
        nxt.zero_()

    def step(fn):
        return lambda: fn(words, f, vis, t.lt.indptr, t.lt.src, t.lt.cumw,
                          key, nxt, listed, count)

    ms = median_ms(step(rrr_expand.rrr_expand_push_lt), reps, restore,
                   hide_host=True)
    call_ms = median_ms(step(rrr_expand.rrr_expand_push_lt), reps, restore)
    plain_ms = median_ms(step(rrr_expand.expand_step_lt_push_plain),
                         plain_reps, restore)
    del f, vis, nxt, listed
    extra["entry_ms"] = median_ms(lambda: rrr_expand.rrr_expand_step_lt(
        frontier, visited, t.lt.indptr, t.lt.src, t.lt.cumw, key), reps)
    torch.cuda.empty_cache()
    row = dict(name="rrr_expand_lt", route="cuda",
               source=SOURCES["rrr_expand_lt"][0],
               replaces=SOURCES["rrr_expand_lt"][1], max_abs_err=err,
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None)
    extra.update(call_ms=call_ms, int_ops=ops_, **work)
    emit(phase="timing", **row, **extra)
    row.update(extra)
    return row


def lt_timings(dev, seeds) -> dict:
    """The LT kernels at the shapes the full-size LT run gives them:
    rrr_expand_lt at the first sampling step of its 32,768-sample draw
    (and of the same draw on the IMM-size rmat graph: hub rows), with
    the selection-plane route beside it; cascade_lt at its spread's first
    step from the run's ``seeds`` (and the densest step of that cascade,
    and the rmat graph's first step), with the live-edge plane route
    beside it; and, under ``selector``, the selector's kernels over the
    LT run's incidence (:func:`selector_timings`), 8.5x denser than
    IC's."""
    args = im_driver.parser().parse_args(LT_FULL)
    key = prng.key(args.seed).fold_in(1)
    g = generators.erdos_renyi(args.n, args.avg_deg, args.seed, device=dev)
    selector = selector_timings(args, *csr.padded_adjacency(g),
                                csr.padded_forward_adjacency(g), dev, "lt")
    t = lt_sampler_tables(g, args.coin_chunk)
    lt = time_lt_step(t, *lt_first_step(t, key, args.max_theta, dev), "lt")
    del t, g
    torch.cuda.empty_cache()
    t = lt_sampler_tables(im_driver.make_graph(
        "rmat", args.n, args.avg_deg, args.seed, dev), args.coin_chunk,
        forward=False)
    lt["shapes"] = {"rmat": time_lt_step(
        t, *lt_first_step(t, key, args.max_theta, dev), "rmat",
        plain_reps=1, composed=False)}
    del t
    torch.cuda.empty_cache()
    casc = cascade_timings(dev, "lt", LT_FULL, seeds)
    casc["shapes"]["rmat"] = cascade_timings(
        dev, "lt rmat", at_scale(LT_FULL, graph="rmat"), seeds, own_run=False)
    return {"rrr_expand_lt": lt, "cascade_lt": casc, "selector": selector}


def cascade_work(step, f, vis) -> dict:
    """What one cascade_ic step's data needs: the valid slots of the rows
    with a word that can still become new (open: a simulation lane not
    yet visited), read once (4 B each); the frontier words gathered at
    them — as row 2's bound, only the non-zero words gathered for open
    words, and never more than the whole frontier plane, which one read
    covers (4 B a word); the probability of each slot whose open
    frontier bits are hashed (4 B); visited read once and both outputs
    written once (12 B a word); and the coins — the open frontier bits
    behind valid slots with p > 0, OPS_PER_COIN each (counting also
    those the kernel skips because an earlier slot of the word already
    hit their bit)."""
    nbr, prob = step["nbr"], step["prob"]
    n, w = f.shape
    open_ = bitset.lane_words(step["num_sims"], f.device)[None] & ~vis
    open_words = (open_ != 0).sum(1)
    slots = (nbr >= 0).sum(1)
    coins, p_reads, gathered = 0, 0, 0
    for r in range(nbr.shape[1]):
        valid = nbr[:, r] >= 0
        fr = f[nbr[:, r].clamp(min=0).long()]
        gathered += int(((fr != 0) & (open_ != 0) & valid[:, None]).sum())
        ok = valid & (prob[:, r] > 0)
        live = torch.where(ok[:, None], fr & open_, 0)
        coins += int(bitset.popcount(live).sum(dtype=torch.int64))
        p_reads += int((live != 0).any(1).sum())
    work = dict(open_words=int(open_words.sum()),
                row_slots=int(((open_words > 0) * slots).sum()),
                gathered=min(gathered, n * w), prob_reads=p_reads,
                coins=coins)
    work["bytes"] = 4 * (work["row_slots"] + work["gathered"] + p_reads
                         + 3 * n * w)
    return work


def lt_cascade_work(step, f, vis) -> dict:
    """What one cascade_lt step's data needs: the row codes (4 B a
    vertex); the valid slots of the rows with an open word, read once
    (4 B each); the frontier words gathered at them — only the non-zero
    ones gathered for open words, and never more than the whole plane
    (4 B a word); for each candidate bit (open, and held by some
    in-neighbour's frontier word) its draw (OPS_PER_COIN), its chosen
    slot's nbr entry and frontier word (8 B); the cumulative weights the
    choices read (:func:`choice_reads`); visited read once and both
    outputs written once (12 B a word).  ``coins`` counts the draws."""
    nbr = step["nbr"]
    n, w = f.shape
    d = nbr.shape[1]
    open_ = bitset.lane_words(step["num_sims"], f.device)[None] & ~vis
    open_words = (open_ != 0).sum(1)
    slots = (nbr >= 0).sum(1)
    cand = torch.zeros_like(f)
    gathered = 0
    for r in range(d):
        valid = nbr[:, r] >= 0
        fr = torch.where(valid[:, None], f[nbr[:, r].clamp(min=0).long()], 0)
        gathered += int(((fr != 0) & (open_ != 0)).sum())
        cand |= fr
    cand &= open_
    draws_v = bitset.popcount(cand).sum(1, dtype=torch.int64)
    cumw_reads = choice_reads(torch.where(step["rows"] >= 0, step["rows"], d),
                              draws_v)
    work = dict(open_words=int(open_words.sum()),
                row_slots=int(((open_words > 0) * slots).sum()),
                gathered=min(gathered, n * w), cumw_reads=cumw_reads,
                coins=int(draws_v.sum()))
    work["bytes"] = (4 * (n + work["row_slots"] + work["gathered"]
                          + cumw_reads) + 8 * work["coins"] + 12 * n * w)
    return work


def step_work(step, f, vis) -> dict:
    return (lt_cascade_work if step["model"] == "LT" else cascade_work)(
        step, f, vis)


def time_cascade_step(label, step, f, vis, reps=10, plain_reps=3) -> dict:
    """cascade_ic or cascade_lt on one step's inputs: equality with its
    plain version at every lane group width, the device time of each
    width (the one the cascade takes is ``ms``), the wrapper call's span
    with its count and the host's share, and the bound of
    :func:`cascade_work` or :func:`lt_cascade_work`."""
    name = cascade_name(step)
    want, plain_once = once(lambda: plain_cascade_step(step, f, vis))
    err = check_cascade_step(step, f, vis, want, dict(input=label))
    new_words = int((want[0] != 0).sum())
    del want
    work = step_work(step, f, vis)
    bound_ms, bound_by, ops_ = bound(work["bytes"],
                                     OPS_PER_COIN * work["coins"])
    by_lanes = {lanes: median_ms(lambda: run_cascade_step(step, f, vis, lanes),
                                 reps, hide_host=True)
                for lanes in CASCADE_LANES}
    lanes = rrr_expand.step_lanes(step["nbr"].shape[1])
    count = torch.zeros(1, dtype=torch.int32, device=f.device)
    call_ms = median_ms(lambda: run_cascade_step(step, f, vis, count=count),
                        reps)
    plain_ms = (median_ms(lambda: plain_cascade_step(step, f, vis),
                          plain_reps) if plain_reps else plain_once)
    torch.cuda.empty_cache()
    row = dict(name=name, route="cuda", source=SOURCES[name][0],
               replaces=SOURCES[name][1], max_abs_err=err,
               ms=by_lanes[lanes], plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None)
    extra = dict(shape=label, n=f.shape[0], d=step["nbr"].shape[1],
                 W=f.shape[1], lanes=lanes, ms_by_lanes=by_lanes,
                 call_ms=call_ms, int_ops=ops_, new_words=new_words, **work)
    emit(phase="timing", **row, **extra)
    row.update(extra)
    return row


def cascade_timings(dev, label, argv, seeds, own_run=True,
                    model=None) -> dict:
    """The cascade kernel of a full-size command's model (cascade_ic or
    cascade_lt; for hub rows also on the IMM command's graph drawn as
    rmat) at its spread: its first step from ``seeds`` (64 simulations,
    as the drivers estimate), then the step of that cascade that draws
    the most coins.  Returns the first step's row with the other under
    ``shapes``; for LT also the route it replaced on the first step's
    inputs (``plane_ms``: cascade._live_mask's plane, drawn once a
    spread; ``plane_step_ms``: rrr_expand_streamed over it).  Without
    ``own_run`` (a graph the command does not run, as the rmat one) the
    first step alone: the rmat graph's LT plane would be 16 GB.
    ``model`` (default the command's) may name WC, which the command
    line does not take."""
    args = im_driver.parser().parse_args(argv)
    model = model or args.model
    g = im_driver.make_graph(args.graph, args.n, args.avg_deg, args.seed, dev)
    key = prng.key(args.seed).fold_in(99)
    step, f, vis = cascade_step(g, args.eval_sims, args.coin_chunk, dev, key,
                                seeds=seeds, model=model)
    row = time_cascade_step(label, step, f, vis)
    if not own_run:
        return row
    if model == "LT":
        nbr, d = step["nbr"], step["nbr"].shape[1]

        def plane():
            return cascade._live_mask(nbr, None, step["wt"], key, model="LT",
                                      num_sims=args.eval_sims, chunk=d,
                                      n_chunks=1, d_pad=d)
        live = plane()
        tbl = torch.where(nbr >= 0, nbr, 0).contiguous()
        if max_err(rrr_expand.rrr_expand_step(f, vis, tbl, live),
                   run_cascade_step(step, f, vis)):
            raise AssertionError(f"cascade_lt != the plane route ({label})")
        row.update(plane_ms=median_ms(plane, 3), plane_step_ms=median_ms(
            lambda: rrr_expand.rrr_expand_step(f, vis, tbl, live), 10))
        emit(phase="timing", name="cascade_lt", shape=label,
             replaced_route=dict(plane_ms=row["plane_ms"],
                                 plane_step_ms=row["plane_step_ms"]))
        del live, tbl
    best = None
    for i in range(64):
        coins = step_work(step, f, vis)["coins"]
        if best is None or coins > best[0]:
            best = (coins, i + 1, f, vis)
        f, vis = run_cascade_step(step, f, vis)
        if not bool(f.any()):
            break
    del f, vis
    dense = time_cascade_step(f"{label} densest step", step, *best[2:],
                              plain_reps=0)
    dense["step"] = best[1]
    row["shapes"] = {f"{label} densest step": dense}
    return row


def selector_timings(args, nbr, prob, wt, fwd, dev, label) -> dict:
    """The IMM selector's kernels over its first round's incidence (a
    ``args.max_theta``-sample draw keyed and cut as ``imm.imm`` draws it,
    under ``args.model``): the machine-axis solve (:func:`time_machine_solve`)
    over the local rows and the receiver (:func:`time_receiver`) over
    their chunk."""
    n, m = args.n, args.machines
    incidence = rrr.sample_incidence(
        nbr, prob, wt, prng.key(args.seed).fold_in(1), theta=args.max_theta,
        n=n, model=args.model, fwd=fwd, max_steps=inspect.signature(
            imm.imm).parameters["max_steps"].default)
    perm = prng.key(args.seed).fold_in(0xC0FFEE).fold_in(1).permutation(
        n, device=dev)
    assign = perm[:(n // m) * m].reshape(m, n // m).long()
    local_rows = incidence[assign].contiguous()
    del incidence
    ex = greedy_pick.excluded_ids(None, m, dev)
    rows_out = time_machine_solve("greedy_pick", local_rows, args.k, ex)
    rows_out["bucket_insert"] = time_receiver(
        "bucket_insert", *imm_chunk(local_rows, assign, dev), label)
    del local_rows
    torch.cuda.empty_cache()
    return rows_out


def main_path_timings(dev, final_seeds) -> dict:
    """Every kernel at the shapes the full run gives it: the first BFS
    step of a 32768-sample draw (rrr_expand_ic also at other steps and
    shapes, :func:`ic_timings`; coin_pack and rrr_expand_streamed as the
    streamed layout's run takes that step, rrr_expand_resident over the
    same plane, both also on a dense step over the same tables), the
    local solves and the receiver of the selector over that incidence,
    and the first cascade step (cascade_ic, then the plane routes'
    rrr_expand_resident and rrr_expand_streamed that the cascade's
    --gather resident and streamed take, under IC and WC)."""
    args = im_driver.parser().parse_args(FULL)
    n, theta, k, m = args.n, args.max_theta, args.k, args.machines
    g = generators.erdos_renyi(n, args.avg_deg, args.seed, device=dev)
    nbr, prob, wt = csr.padded_adjacency(g)
    fwd = csr.padded_forward_adjacency(g)
    key = prng.key(args.seed).fold_in(1)
    t = rrr._Tables(nbr, prob, wt, *fwd, model="IC",
                    coin_chunk=args.coin_chunk)
    frontier, visited, keys = ic_first_step(t, key, theta, dev)
    W = frontier.shape[1]
    rows_out = {}

    fb = 4 * frontier.numel()
    rows_out["coin_pack"] = timed(
        "coin_pack", lambda: [coins.coin_plane(keys, t.prob_p, frontier,
                                               t.chunk)],
        lambda: [coins.coin_plane_plain(keys, t.prob_p, frontier, t.chunk)],
        10, 3, bytes_=fb + 4 * t.prob_p.numel() + 4 * n * t.d_pad * W,
        ops_=OPS_PER_COIN * coins_needed(t, frontier))

    plane = coins.coin_plane(keys, t.prob_p, frontier, t.chunk
                             ).reshape(n * t.d_pad, W)
    lines = rrr_expand.line_summary(frontier)       # the roots' summary
    res_args = (frontier, visited, t.nbr_c, t.gidx, plane)
    rows_out["rrr_expand_resident"] = time_plane_step(
        "rrr_expand_resident", "imm", res_args, t.slots, lines, res_args)
    # the streamed layout's step: the plane gathered into [n, df, W] as
    # rrr._planes gathers it (one pass through t.take) and as it was
    # gathered before (an advanced index, then torch.where's zeroed copy)
    def gather():
        return plane.index_select(0, t.take).view(n, -1, W)

    def old_gather():
        return torch.where(t.valid[:, :, None], plane.view(n, t.d_pad, W)[
            t.nbr_c.long(), t.rslot], 0)
    old_gather_ms = median_ms(old_gather, 3)
    gm_old = old_gather()
    gather_ms = median_ms(gather, 3)
    gm = gather()
    row = time_plane_step(
        "rrr_expand_streamed", "imm", (frontier, visited, t.nbr_c, gm),
        t.slots, lines, (frontier, visited, t.nbr_c, gm_old))
    row.update(gmask_shape=list(gm.shape), gather_ms=gather_ms,
               old_gather_ms=old_gather_ms)
    emit(phase="timing", name="rrr_expand_streamed", shape="imm gather",
         gather_ms=gather_ms, old_gather_ms=old_gather_ms)
    rows_out["rrr_expand_streamed"] = row
    # a dense step on the same tables: every frontier word non-zero, every
    # line live
    dense = frontier | 1
    every = torch.ones_like(lines)
    label = "imm, every line live"
    rows_out["rrr_expand_resident"]["shapes"] = {label: time_plane_step(
        "rrr_expand_resident", label, (dense, visited, t.nbr_c, t.gidx,
                                       plane), t.slots, every,
        (dense, visited, t.nbr_c, t.gidx, plane), plain_reps=0)}
    row["shapes"] = {label: time_plane_step(
        "rrr_expand_streamed", label, (dense, visited, t.nbr_c, gm), t.slots,
        every, (dense, visited, t.nbr_c, gm_old), plain_reps=0)}
    del gm, gm_old, dense
    torch.cuda.empty_cache()
    rows_out["rrr_expand_ic"] = time_ic_step(t, frontier, visited, keys,
                                             "imm", plane=plane)
    del plane
    rows_out["rrr_expand_ic"]["shapes"] = ic_timings(
        t, key, (frontier, visited, keys), dev)
    del t, frontier, visited

    rows_out.update(selector_timings(args, nbr, prob, wt, fwd, dev, "imm"))

    rows_out["cascade_ic"] = cascade_timings(dev, "imm", FULL, final_seeds)
    sims = args.eval_sims
    chunk, n_chunks, d_pad = rrr._coin_chunks(nbr.shape[1], args.coin_chunk)
    tbl = torch.nn.functional.pad(torch.where(nbr >= 0, nbr, 0),
                                  (0, d_pad - nbr.shape[1])).contiguous()
    gidx = (torch.arange(n, dtype=torch.int32, device=dev)[:, None] * d_pad
            + torch.arange(d_pad, dtype=torch.int32, device=dev)[None, :])
    slots = (nbr >= 0).sum(1, dtype=torch.int32)
    smask = cascade.seeds_to_mask(n, final_seeds, device=dev)
    act = torch.where(smask[:, None],
                      bitset.lane_words(sims, dev)[None], 0
                      ).to(torch.int32)
    lines = rrr_expand.line_summary(act)            # the seed rows
    for label, model in (("cascade", "IC"), ("wc", "WC")):
        # the plane routes' first step: the live-edge plane, gathered
        # (streamed) or read through the identity index (resident)
        live = cascade._live_mask(
            nbr, cascade._edge_prob(nbr, prob, wt, model), wt,
            prng.key(args.seed).fold_in(99), model=model, num_sims=sims,
            chunk=chunk, n_chunks=n_chunks, d_pad=d_pad)
        for name, step_args in (
                ("rrr_expand_resident",
                 (act, act, tbl, gidx, live.reshape(n * d_pad, -1))),
                ("rrr_expand_streamed", (act, act, tbl, live))):
            rows_out[name].setdefault("shapes", {})[label] = time_plane_step(
                name, label, step_args, slots, lines, step_args)
        del live
    return rows_out


PLANE_STEPS = {
    "rrr_expand_resident": (rrr_expand.rrr_expand_step_resident,
                            rrr_expand.expand_step_resident_plain),
    "rrr_expand_streamed": (rrr_expand.rrr_expand_step,
                            rrr_expand.expand_step_plain)}


def plane_work(f, fwd_nbr, slots, resident: bool) -> dict:
    """What one plane step (row 1 or 2) with its per-row count and the
    frontier's line summary needs: the count (4 B a row) and each valid
    slot's index (4 B, and its gidx entry on the resident layout); the
    summary read and the next one written (a byte a line each); the
    frontier lines with a set bit behind a valid slot (4 B a word of
    them, as row 2c counts only the non-zero frontier words it gathers,
    and never more than the whole plane, which one read covers); a mask
    word behind each non-zero frontier word of those lines (4 B); visited
    read once and both outputs written once (12 B a word)."""
    n, w = f.shape
    live = rrr_expand.line_summary(f).bool()
    per_line = torch.full((live.shape[1],), rrr_expand.LINE_WORDS,
                          dtype=torch.int64, device=f.device)
    per_line[-1] = w - rrr_expand.LINE_WORDS * (live.shape[1] - 1)
    line_words = mask_words = 0
    for s in range(fwd_nbr.shape[1]):
        ok = s < slots
        v = fwd_nbr[:, s].long()
        line_words += int((live[v][ok].long() * per_line).sum())
        mask_words += int((f[v][ok] != 0).sum())
    valid = int(slots.sum(dtype=torch.int64))
    work = dict(valid_slots=valid, frontier_words=min(line_words, n * w),
                mask_words=mask_words, lines=live.numel())
    work["bytes"] = (4 * n + 4 * valid * (2 if resident else 1)
                     + 2 * live.numel() + 4 * work["frontier_words"]
                     + 4 * mask_words + 12 * n * w)
    return work


def time_plane_step(name, label, args, slots, lines, old_args, reps=10,
                    plain_reps=3) -> dict:
    """Row 1 (``rrr_expand_resident``) or 2 (``rrr_expand_streamed``) at
    one step: the kernel given the per-row count ``slots`` and the line
    summary ``lines`` (writing the next summary and the count) against
    its plain version on the same inputs (equal words; the summary and
    count equal to the new frontier's lines), device times with the
    host's queueing hidden, the bound of :func:`plane_work`, and
    ``old_ms``: the kernel as its callers ran it before either input
    (every slot, every line) on ``old_args``, the same step in the
    reference's form, which must give the same words."""
    step, plain = PLANE_STEPS[name]
    f = args[0]
    n, w = f.shape
    nl = torch.empty((n, rrr_expand.num_lines(w)), dtype=torch.uint8,
                     device=f.device)
    count = torch.empty(1, dtype=torch.int32, device=f.device)
    opts = dict(slots=slots, lines=lines, next_lines=nl, count=count)
    got = step(*args, **opts)
    want = rrr_expand.line_summary(got[0])
    if not torch.equal(nl, want) or int(count) != int(want.sum()):
        raise AssertionError(f"{name}: the summary or count is not the new "
                             f"frontier's ({label})")
    if max_err(got, step(*old_args)):
        raise AssertionError(f"{name}: != the step every slot and line read "
                             f"({label})")
    new_lines = int(count)
    del got, want
    work = plane_work(f, args[2], slots, name == "rrr_expand_resident")
    row = timed(name, lambda: step(*args, **opts),
                lambda: plain(*args, **opts), reps, plain_reps,
                bytes_=work["bytes"], hide_host=True)
    row.update(shape=label, n=n, df=args[2].shape[1], W=w,
               old_ms=median_ms(lambda: step(*old_args), reps,
                                hide_host=True),
               new_lines=new_lines, **work)
    emit(phase="timing", name=name, shape=label, ms=row["ms"],
         old_ms=row["old_ms"], bound_ms=row["bound_ms"],
         new_lines=new_lines, **work)
    return row


def round_timings(dev) -> dict:
    """The slice-2 kernels at the shapes the full-size round gives them:
    the lazy senders over the shuffled [8, 32768, 4096] rows, one fused
    pick over the same rows, the stream receiver over the 800 x 4096
    candidate stream through 63 buckets, and one Ripples pick over the
    machines' [8, 262144, 512] samples."""
    args = im_driver.parser().parse_args(ROUND)
    n, k = args.n, args.k
    g = generators.erdos_renyi(n, args.avg_deg, args.seed, device=dev)
    nbr, prob, wt = csr.padded_adjacency(g)
    fwd = csr.padded_forward_adjacency(g)
    key = prng.key(args.seed)
    fn, _, _ = greediris.build_round(
        m=args.machines, n=n, theta=args.theta, k=k, max_degree=0,
        model=args.model, sampler="kernel", fwd=fwd)
    x_s, perm = fn.sample_shuffle(nbr, prob, wt, key)
    m, per, w = x_s.shape
    ex = greedy_pick.excluded_ids(None, m, dev)
    rows_out = {}

    solve = time_machine_solve("lazy_greedy", x_s, k, ex)
    rows_out["compact_rows round"] = solve.pop("compact_rows")
    rows_out.update(solve)
    # the tiles of a machine that every pick's first phase sweeps on the
    # dense layout
    rows_out["lazy_greedy"]["phase1_tiles_per_pick"] = (
        lazy_greedy.blocks_per_machine(m, per, w, dev))
    # what the lazy bound saves: the resident solve on the same rows (the
    # wrapper: the list, then the compact picks)
    rows_out["lazy_greedy_compact"]["resident_ms"] = median_ms(
        lambda: greedy_pick.greedy_maxcover_resident(x_s, k, ex), 3)

    cov0 = torch.zeros((m, w), dtype=torch.int32, device=dev)
    none = torch.zeros((m, per), dtype=torch.bool, device=dev)
    rows_out["topk_gain"] = timed(
        "topk_gain", lambda: topk_gain.best_gain_index(x_s, cov0, none),
        lambda: topk_gain.best_gain_index_plain(x_s, cov0, none), 10, 3,
        bytes_=4 * (x_s.numel() + m * w + 2 * m) + none.numel(),
        words=x_s.numel(), nonzero=int((x_s != 0).sum()))
    rows_out["bucket_insert_stream"] = time_receiver(
        "bucket_insert_stream", *round_stream(x_s, perm, dev), "round")
    del x_s

    rf, _ = greediris.build_ripples_round(
        m=m, n=n, theta=args.theta, k=k, model=args.model, sampler="kernel",
        fwd=fwd)
    x = rf.sample(nbr, prob, wt, key)
    cov0 = torch.zeros((m, x.shape[2]), dtype=torch.int32, device=dev)
    rows_out["coverage"] = timed(
        "coverage", lambda: [coverage.marginal_gain(x, cov0)],
        lambda: [coverage.marginal_gain_plain(x, cov0)], 10, 3,
        bytes_=4 * (x.numel() + cov0.numel() + m * n),
        words=x.numel(), nonzero=int((x != 0).sum()))
    return rows_out


def serve_timings(dev, svc_lazy, trace) -> dict:
    """The slice-3 kernels: bucket_gains at the receiver's shape (B = 63
    buckets of W = 4096 words), and the query-axis solves over the serve
    phase's final pool (n = 262,144, W = 4096) with its last batch of 8
    queries (their exclusions, k = the batch's largest k), then again
    with exclusions that make the 8 queries' picks diverge."""
    rows_out = {}
    gen = torch.Generator().manual_seed(13)
    b, w = 63, 4096
    row = rand_words(gen, w, dev=dev) & rand_words(gen, w, dev=dev)
    covers = rand_words(gen, b, w, dev=dev) & rand_words(gen, b, w, dev=dev)
    rows_out["bucket_gains"] = timed(
        "bucket_gains", lambda: [bucket.bucket_gains(row, covers)],
        lambda: [bucket.bucket_gains_plain(row, covers)], 50, 10,
        bytes_=4 * (b * w + w + b), words=b * w,
        nonzero=int(((row[None] & ~covers) != 0).sum()), hide_host=True)
    # ms is the device span; the wrapper's time keeps the host's path to
    # the launch (checks, the output's allocation, the C call)
    rows_out["bucket_gains"].update(
        B=b, W=w, cluster=bucket.launch_cluster(b, w, True, dev),
        wrapper_ms=median_ms(lambda: bucket.bucket_gains(row, covers), 50))

    pool = svc_lazy.pool
    r1 = pool.r1
    svc_lazy._pools.clear()                 # keep only R1 of the last pool
    del pool
    n, w = r1.shape
    queries = trace[-8:]
    k, excl, _, _ = service._query_arrays(queries, n, 32 * w)
    ex = torch.from_numpy(excl).to(dev)
    bq = ex.shape[0]
    shared = r1[None].expand(bq, n, w)
    need = {}
    out_bytes = 4 * (bq * k * w + bq * w + 2 * bq * k)
    tile_bytes = 4 * lazy_greedy.TILE_ROWS * w
    g_res, groups_res = greedy_pick.query_plan("greedy_pick", bq, w, dev)
    g_lazy, groups_lazy = greedy_pick.query_plan("lazy_greedy", bq, w, dev)

    def shared_rows(stats):
        return stats["tiles_needed_shared"] * lazy_greedy.TILE_ROWS

    def needed_words(stats):
        return lazy_greedy.TILE_ROWS * int(stats["tiles_needed"].sum()) * w

    def group_sweep_bytes(swept):
        # a tile swept for a group is read once for all its queries
        return tile_bytes * sum(int(t) for t in swept[::g_lazy])

    torch.cuda.empty_cache()
    rows_out["lazy_greedy_batch"] = timed(
        "lazy_greedy_batch",
        lambda: lazy_greedy.greedy_maxcover_lazy_batch(r1, k, ex)[:4],
        lambda: lazy_greedy.lazy_plain(shared, k, ex, stats=need)[:4], 3, 0,
        bytes_=lambda: 4 * shared_rows(need) * w + out_bytes,
        words=lambda: needed_words(need),
        nonzero=lambda: need["nonzero_words_needed"])
    swept = lazy_greedy.greedy_maxcover_lazy_batch(r1, k, ex)[4].tolist()
    rows_out["lazy_greedy_batch"].update(
        B=bq, n=n, W=w, k=k, G=g_lazy, groups=groups_lazy,
        tiles_swept=swept, sweep_bytes=group_sweep_bytes(swept),
        # one popcount for every word the kernel sweeps, zero or not
        popc_each_word_ms=lazy_greedy.TILE_ROWS * w * sum(swept)
        / POPC_PER_S * 1e3,
        tiles_needed=need["tiles_needed"].tolist(),
        tiles_needed_shared=need["tiles_needed_shared"],
        num_tiles=lazy_greedy.num_row_tiles(n))
    torch.cuda.empty_cache()
    rows_out["greedy_pick_batch"] = timed(
        "greedy_pick_batch",
        lambda: greedy_pick.greedy_maxcover_resident_batch(r1, k, ex),
        lambda: greedy_pick.greedy_plain(shared, k, ex), 3, 0,
        bytes_=4 * shared_rows(need) * w + out_bytes,
        words=needed_words(need), nonzero=need["nonzero_words_needed"])
    rows_out["greedy_pick_batch"].update(
        B=bq, n=n, W=w, k=k, G=g_res, groups=groups_res,
        sweep_bytes=4 * k * r1.numel() * groups_res,
        popc_each_word_ms=bq * k * r1.numel() / POPC_PER_S * 1e3,
        tiles_needed_shared=need["tiles_needed_shared"])

    # A batch whose picks diverge: query q keeps every 8th of the first
    # 8 x 12 unconstrained seeds (those at q, q + 8, ...) and excludes
    # the other 84, so each query starts from seeds of its own.
    none = torch.full((1, 1), -1, dtype=torch.int32, device=dev)
    top = lazy_greedy.greedy_maxcover_lazy_batch(r1, 12 * bq, none)[0][0]
    keep = torch.arange(12 * bq, device=dev) % bq
    ex_div = torch.stack([top[keep != q] for q in range(bq)]).contiguous()
    need_div = {}
    want, plain_once = once(lambda: lazy_greedy.lazy_plain(
        shared, k, ex_div, stats=need_div)[:4])
    got_res = greedy_pick.greedy_maxcover_resident_batch(r1, k, ex_div)
    *got_lazy, swept_div = lazy_greedy.greedy_maxcover_lazy_batch(r1, k, ex_div)
    errs = {"greedy_pick_batch": max_err(got_res, want),
            "lazy_greedy_batch": max_err(got_lazy, want)}
    div_seeds = [tuple(x) for x in got_res[0].tolist()]
    del want, got_res, got_lazy
    bound_ms, bound_by, _ = bound(
        4 * shared_rows(need_div) * w + out_bytes,
        words=needed_words(need_div),
        nonzero=need_div["nonzero_words_needed"])
    common = dict(
        exclusions_per_query=int((ex_div >= 0).sum(1).max()),
        distinct_seed_sets=len(set(div_seeds)),
        distinct_seeds=len({v for sd in div_seeds for v in sd if v >= 0}),
        tiles_needed=need_div["tiles_needed"].tolist(),
        tiles_needed_shared=need_div["tiles_needed_shared"],
        bound_ms=bound_ms, bound_by=bound_by, plain_ms=plain_once)
    swept_div = swept_div.tolist()
    divs = {
        "greedy_pick_batch": dict(
            common, max_abs_err=errs["greedy_pick_batch"],
            ms=median_ms(lambda: greedy_pick.greedy_maxcover_resident_batch(
                r1, k, ex_div), 3),
            sweep_bytes=4 * k * r1.numel() * groups_res),
        "lazy_greedy_batch": dict(
            common, max_abs_err=errs["lazy_greedy_batch"],
            ms=median_ms(lambda: lazy_greedy.greedy_maxcover_lazy_batch(
                r1, k, ex_div), 3),
            tiles_swept=swept_div, sweep_bytes=group_sweep_bytes(swept_div))}
    for name, div in divs.items():
        emit(phase="timing", batch="diverging", name=name, **div)
        rows_out[name]["diverging"] = div
        rows_out[name]["max_abs_err"] = max(rows_out[name]["max_abs_err"],
                                            div["max_abs_err"])
        if div["max_abs_err"]:
            raise AssertionError(f"{name}: kernel != plain on the diverging "
                                 "batch")
    cov0 = torch.zeros((bq, w), dtype=torch.int32, device=dev)
    picked = torch.zeros((bq, n), dtype=torch.bool, device=dev)
    rows_ex = ex.long().clamp(min=0)
    picked[torch.arange(bq, device=dev)[:, None].expand_as(ex)[ex >= 0],
           rows_ex[ex >= 0]] = True
    rows_out["topk_gain_batch"] = timed(
        "topk_gain_batch",
        lambda: topk_gain.best_gain_index_batch(r1, cov0, picked),
        lambda: topk_gain.best_gain_index_plain(shared, cov0, picked), 10, 1,
        bytes_=4 * (r1.numel() + bq * w + 2 * bq) + picked.numel(),
        words=bq * r1.numel(),
        nonzero=int(((r1 != 0).sum(1)[None] * ~picked).sum()))
    g_fused, groups_fused = greedy_pick.query_plan("topk_gain", bq, w, dev)
    rows_out["topk_gain_batch"].update(
        B=bq, n=n, W=w, G=g_fused, groups=groups_fused,
        sweep_bytes=4 * r1.numel() * groups_fused)
    return rows_out


def spread_splits(dev, runs: dict):
    """The spread of each full-size command's seeds split into its parts
    (``tools/time_spread.py``'s clock, medians of 3 after a warm-up): the
    kernel route of its model (``auto``: cascade_ic or cascade_lt) and
    the plane route it replaced (``streamed``: the live-edge plane,
    rrr_expand_streamed), whose spreads must agree."""
    for label, (argv, seeds) in runs.items():
        args = im_driver.parser().parse_args(argv)
        g = im_driver.make_graph(args.graph, args.n, args.avg_deg, args.seed,
                                 dev)
        rows = [split_spread(g, torch.from_numpy(seeds),
                             prng.key(args.seed).fold_in(99), gather=gather,
                             model=args.model, num_sims=args.eval_sims)
                for gather in ("auto", "streamed")]
        for row in rows:
            emit(phase="spread_split", command=label, n=args.n,
                 edges=g.num_edges, **row)
        if rows[0]["spread"] != rows[1]["spread"]:
            raise AssertionError(f"{label}: the spread's routes disagree")
        del g
        torch.cuda.empty_cache()


def contracts_phase(dev) -> None:
    """The launch and footprint checker on the card: every contract of
    the registry and the AST lint (``repro_torch.analysis.check --all``),
    one line a contract; every device function's static shared memory,
    registers and local memory (``cudaFuncGetAttributes``); and the
    model's dynamic shared memory of every launch at the full-size
    shapes of PERF.md section 4 (``smem_budget.FULL_SIZE``), equal to the
    C side's and within the opt-in limit with the static figure."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "contracts.json")
        with contextlib.redirect_stdout(sys.stderr):
            rc = check.main(["--all", "--device", "cuda", "--repo-root",
                             ROOT, "--json", path])
        with open(path) as fh:
            report = json.load(fh)
    for row in report["contracts"]:
        emit(phase="contracts", **row)
    emit(phase="contracts", name="ast-lint",
         ok=not report["ast"]["violations"], **report["ast"])
    table = contracts.device_kernels(dev)
    emit(phase="kernel_attributes", kernels={
        launch: [{k: e[k] for k in ("name", *contracts.ATTRIBUTES)}
                 for e in entries] for launch, entries in table.items()})
    budget = smem_budget.budget_bytes(dev)
    shapes, bad = [], []
    for kernel in ops.KERNELS:
        entries = table[kernel]
        static = max(e["static_smem"] for e in entries)
        for cell, w, x in smem_budget.FULL_SIZE[kernel]:
            dyn = smem_budget.launch_bytes(kernel, w, x)
            row = dict(kernel=kernel, cell=cell, W=w, x=x, dynamic=dyn,
                       c_dynamic=contracts.c_launch_bytes(
                           entries[0]["lib"], kernel, w, x, dev),
                       static=static,
                       model_static=smem_budget.STATIC_BYTES[kernel])
            row["ok"] = (row["c_dynamic"] == dyn and static
                         == row["model_static"] and dyn + static <= budget)
            shapes.append(row)
            if not row["ok"]:
                bad.append(row)
    emit(phase="smem_full_size", budget=budget, shapes=shapes)
    if rc or bad:
        raise AssertionError(f"the contract checker failed (rc {rc}) or "
                             f"the model disagrees at full size: {bad}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stop-after", choices=("build", "contracts", "parity",
                                             "paths", "full", "round",
                                             "serve", "lm"),
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
    lap("build")
    regs = [ln.strip() for name in build.LIBS
            for ln in build.build_log(name).splitlines()
            if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=build_s, ptxas=regs)
    if args.stop_after == "build":
        return 0
    contracts_phase(dev)
    lap("contracts")
    if args.stop_after == "contracts":
        return 0

    errs = parity_small(dev)
    if args.stop_after == "parity":
        return 0
    paths_agree(dev)
    round_paths_agree(dev)
    serve_paths_agree(dev)
    engines_agree(dev)
    lap("paths")
    if args.stop_after == "paths":
        return 0
    launches, full_out = full_run()
    seeds = full_out["seeds"]
    lap("full")
    full = {"imm": launches}
    full["imm streamed"] = streamed_run(full_out)
    del full_out
    lap("streamed")
    full.update(wc_spread(dev, seeds))
    lap("wc")
    full["lt"], lt_seeds = lt_run()
    lap("lt")
    if args.stop_after == "full":
        return 0
    full.update(round_runs(dev))
    lap("round")
    full["faulted lazy"] = faulted_round(dev)["faulted lazy"]
    lap("faulted")
    dense_launches, dense_seeds = supercritical_runs()
    full.update(dense_launches)
    lap("supercritical")
    if args.stop_after == "round":
        return 0
    serve_launches, svc_lazy, trace = serve_runs(dev)
    full.update(serve_launches)
    lap("serve")
    if args.stop_after == "serve":
        return 0
    lm_phase(dev, card, emit)
    lap("lm")
    if args.stop_after == "lm":
        return 0
    rows = serve_timings(dev, svc_lazy, trace)
    del svc_lazy
    lap("timing serve")
    rows.update(main_path_timings(dev, torch.from_numpy(seeds)))
    lap("timing imm")
    lt_rows = lt_timings(dev, torch.from_numpy(lt_seeds))
    lt_select = lt_rows.pop("selector")
    rows.update(lt_rows)
    lap("timing lt")
    rows["rrr_expand_ic"]["shapes"]["rmat"] = rmat_ic_timing(dev)
    rows.update(round_timings(dev))
    lap("timing rmat ic, round")
    rows["compact_rows"]["shapes"] = {"round": rows.pop("compact_rows round")}
    # the dense sweeps at the shapes their runs give them; the same
    # sweeps forced on the subcritical runs' rows kept beside
    dense_rows = supercritical_timings(dev)
    for name, parts in dense_rows.pop("handover").items():
        rows[name].setdefault("shapes", {}).update(parts)
    for name, row in dense_rows.items():
        if name in RECEIVER_RUN:   # the receivers keep their full-size row
            rows[name].setdefault("shapes", {})["supercritical"] = row
            continue
        row["shapes"] = {"forced on the subcritical "
                         + ("round's" if name == "lazy_greedy" else "IMM's")
                         + " rows": rows[name]}
        rows[name] = row
    # the LT run's selector kernels at the shapes its denser incidence
    # gives them (phase `order` charges its launches there)
    rows["greedy_pick"]["shapes"]["forced on the LT IMM's rows"] = (
        lt_select.pop("greedy_pick"))
    for name, row in lt_select.items():
        rows[name].setdefault("shapes", {})["lt"] = row
    dense = cascade_timings(dev, "supercritical", DENSE_FULL,
                            torch.from_numpy(dense_seeds))
    rows["cascade_ic"]["shapes"].update(supercritical=dense,
                                        **dense.pop("shapes"))
    hubs = cascade_timings(dev, "rmat", at_scale(FULL, graph="rmat"),
                           torch.from_numpy(seeds))
    rows["cascade_ic"]["shapes"].update(rmat=hubs, **hubs.pop("shapes"))
    wc = cascade_timings(dev, "wc", FULL, torch.from_numpy(seeds),
                         model="WC")
    rows["cascade_ic"]["shapes"].update(wc=wc, **wc.pop("shapes"))
    lap("timing supercritical, rmat, wc cascade")
    spread_splits(dev, {"imm": (FULL, seeds),
                        "supercritical": (DENSE_FULL, dense_seeds),
                        "lt": (LT_FULL, lt_seeds)})
    kernels, order = [], []
    for name in ops.KERNELS:
        row = rows[name]
        row["max_abs_err"] = max([row["max_abs_err"], errs[name]] + [
            r["max_abs_err"] for r in row.get("shapes", {}).values()])
        if name in SLICE1:
            row["launches"] = full["imm"][name]
        elif name in LT_RUN:
            row["launches"] = full["lt"][name]
        elif name in ROUND_RUN:
            row["launches"] = full[ROUND_RUN[name]][name]
        elif name in SERVE_RUN:
            row["launches"] = full[SERVE_RUN[name]][name]
        elif name in STREAMED_RUN:
            row["launches"] = full["imm streamed"][name]
        elif name in PLANE_RUN:
            row["launches_from"] = PLANE_RUN[name]
            row["launches"] = full[PLANE_RUN[name]][name]
        elif name in DENSE_RUN:
            row["launches"] = full[DENSE_RUN[name]][name]
            row["launches_from"] = DENSE_RUN[name]
        else:
            row["launches"] = 0
            row["launches_from"] = "on no path of the reference"
        if name in RECEIVER_RUN:
            row["launches_supercritical"] = full[RECEIVER_RUN[name]][name]
        launched = {run: c[name] for run, c in full.items() if c.get(name)}
        if launched and not row["launches"]:
            raise AssertionError(f"{name}: the full-size runs launched it "
                                 f"({launched}) but its row reports none")
        kernels.append(row)
        # Redesign order: the time each kernel loses over the full-size
        # runs, sum over runs of launches x (ms - bound_ms) at the run's
        # shape where the kernel was timed at several.
        # A supercritical run counts for the kernels timed at its shape:
        # its dense launch (to its handover, ``dense_ms``), the handover's
        # compaction and compact picks (one each a handover; the
        # compaction that chose the layout is not charged), and its
        # receiver.
        per_run = {run: full[run][name] for run in FULL_RUNS
                   if full[run][name]}
        if name in DENSE_RUN:
            per_run[DENSE_RUN[name]] = full[DENSE_RUN[name]][name]
        if name in RECEIVER_RUN and full[RECEIVER_RUN[name]][name]:
            per_run[RECEIVER_RUN[name]] = full[RECEIVER_RUN[name]][name]
        for dense_name, run in DENSE_RUN.items():
            handed = full[run][dense_name + "_compact"]
            if handed and f"{run} handover" in row.get("shapes", {}):
                per_run[f"{run} handover"] = handed
        lost = 0.0
        for run, count in per_run.items():
            at = (dict(ms=row["dense_ms"], bound_ms=row["bound_ms"])
                  if run == DENSE_RUN.get(name) else
                  row["shapes"]["supercritical"]
                  if run == RECEIVER_RUN.get(name) else
                  row["shapes"][run] if run.endswith(" handover") else
                  row.get("shapes", {}).get(FULL_RUNS[run], row))
            lost += count * (at["ms"] - at["bound_ms"])
        order.append(dict(name=name, lost_ms=lost, launches=per_run,
                          total_launches=sum(per_run.values()),
                          **({} if per_run else dict(
                              small_launches=row["launches"],
                              launches_from=row.get("launches_from")))))
    emit(phase="order", kernels=sorted(order, key=lambda r: -r["lost_ms"]))
    lap("spread split, order")
    emit(phase="done", seconds=time.perf_counter() - t_start,
         split=lap_seconds(t_start))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
