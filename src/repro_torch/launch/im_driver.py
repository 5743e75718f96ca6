"""Influence-maximization driver (twin of ``repro.launch.im_driver``):
the IMM martingale loop, or with ``--theta`` the fixed-theta
distributed GreediRIS round, then the spread estimate, on one device.

  PYTHONPATH=src python -m repro_torch.launch.im_driver --graph er \
      --n 262144 --avg-deg 4 --k 100 --selector greediris --machines 8 \
      --sampler kernel --gather resident --solver resident --use-kernel \
      --max-theta 32768 --eval-engine kernel --eval-sims 64

  PYTHONPATH=src python -m repro_torch.launch.im_driver --graph er \
      --n 262144 --avg-deg 4 --k 100 --machines 8 --theta 131072 \
      --selector greediris --sampler kernel --solver lazy --use-kernel \
      --chunk-size auto --eval-engine kernel --eval-sims 64

Same flag names and ``[im]`` lines as the reference.  The port's
defaults are the kernel paths; ``--device`` (default ``cuda``) picks
the device and never falls back.  On one card ``--machines`` sets the
round's machine count m (the reference takes its device count).
``--use-opim`` runs the OPIM-C loop instead of IMM, and ``--serve``
hands the graph, model, solver and sampler flags to the serving replay
(``repro_torch.launch.serve --check``).  ``--eval-spread`` estimates the
spread with every cascade engine and requires one value; ``--faults``
runs the fault-injected resilient round
(``runtime.faults.resilient_randgreedi``) instead of the normal one.

  PYTHONPATH=src python -m repro_torch.launch.im_driver --graph er \
      --n 262144 --avg-deg 4 --k 100 --machines 8 --theta 131072 \
      --sampler kernel --solver lazy --eval-engine kernel --eval-sims 64 \
      --faults local.greedy:drop:3 --faults receiver.insert:raise:0 \
      --fault-report report.json
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import (StageClock, cascade, greediris, imm,
                              maxcover, opim, prng, resolve_device, rrr,
                              theory)
from repro_torch.core.diffusion import influence
from repro_torch.core.rrr import graph_tables, resolve_sampler
from repro_torch.graphs import generators
from repro_torch.runtime import faults
from repro_torch.runtime.fault_tolerance import StragglerMonitor


def _coin_chunk_arg(text: str) -> int:
    try:
        v = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer slot count, got {text!r}") from None
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def _chunk_size_arg(text: str):
    """--chunk-size: 'auto', 0 (the default policy) or a positive
    candidate count."""
    if text == "auto":
        return "auto"
    try:
        v = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected 'auto' or an integer candidate count, got "
            f"{text!r}") from None
    if v < 0:
        raise argparse.ArgumentTypeError(
            f"must be >= 0, got {v}: a candidate count, 0 for the default "
            "policy, or 'auto'")
    return v or None


def _block_v_arg(text: str):
    """--block-v: 'auto' or a positive row-tile size, validated as the
    reference validates it.  The value is ignored: the port's kernels
    fix their tiles, and no result depends on it."""
    if text == "auto":
        return None
    try:
        v = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected 'auto' or an integer row-tile size, got "
            f"{text!r} (e.g. --block-v 128)") from None
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def make_graph(kind: str, n: int, avg_deg: float, seed: int, device):
    if kind == "er":
        return generators.erdos_renyi(n, avg_deg, seed, device=device)
    if kind == "ba":
        return generators.preferential_attachment(n, int(avg_deg), seed,
                                                  device=device)
    return generators.rmat(int(np.ceil(np.log2(n))), int(n * avg_deg),
                           seed=seed, device=device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="er", choices=("er", "ba", "rmat"))
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--avg-deg", type=float, default=8.0)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--eps", type=float, default=0.13)
    ap.add_argument("--delta", type=float, default=0.077)
    ap.add_argument("--model", default="IC", choices=("IC", "LT"))
    ap.add_argument("--selector", default="greediris",
                    choices=("greedy", "ripples", "randgreedi",
                             "greediris", "greediris-trunc"))
    ap.add_argument("--alpha", type=float, default=0.125)
    ap.add_argument("--aggregate", default="gather",
                    choices=("gather", "pipeline"))
    ap.add_argument("--machines", type=int, default=0,
                    help="machine count m on the one device (0 = 1)")
    ap.add_argument("--max-theta", type=int, default=1 << 14)
    ap.add_argument("--theta", type=int, default=0)
    ap.add_argument("--use-opim", action="store_true")
    ap.add_argument("--solver", default="resident",
                    choices=("scan", "fused", "resident", "lazy"),
                    help="local greedy path: 'scan' (plain PyTorch), "
                         "'fused' (one CUDA launch per pick), 'resident' "
                         "(one launch for all k picks of all machines) or "
                         "'lazy' (resident with stale tile bounds); "
                         "bit-identical")
    ap.add_argument("--sampler", default="kernel",
                    choices=("dense", "packed", "kernel"),
                    help="S1 path: 'dense' (the reference's bool-state "
                         "BFS in plain PyTorch; small graphs), 'packed' "
                         "(plain PyTorch) or 'kernel' (coin and expansion "
                         "CUDA kernels); bit-identical")
    ap.add_argument("--gather", default="auto",
                    choices=("resident", "streamed", "auto"),
                    help="expansion kernel layout ('auto' = resident)")
    ap.add_argument("--block-v", type=_block_v_arg, default=None,
                    help="the reference's sampler row-tile size, or "
                         "'auto'; accepted and ignored (the port's kernels "
                         "fix their tiles; never affects results)")
    ap.add_argument("--coin-chunk", type=_coin_chunk_arg, default=32)
    ap.add_argument("--use-kernel", action="store_true",
                    help="route the streaming receiver through its "
                         "kernels (the sender path is --solver)")
    ap.add_argument("--chunk-size", type=_chunk_size_arg, default=None,
                    help="receiver chunking of the fixed-theta round: "
                         "'auto', 0 (default policy) or a count (not used "
                         "by the IMM loop)")
    ap.add_argument("--eval-sims", type=int, default=32)
    ap.add_argument("--eval-engine", default="kernel",
                    choices=("map", "packed", "kernel"))
    ap.add_argument("--eval-spread", action="store_true",
                    help="after selection, estimate the spread with every "
                         "cascade engine (map, packed, kernel) and require "
                         "one value")
    ap.add_argument("--serve", action="store_true",
                    help="run the serving replay (repro_torch.launch.serve "
                         "--check) on the same graph, model, solver and "
                         "sampler flags instead of one selection")
    ap.add_argument("--faults", action="append", default=[],
                    type=faults.cli_fault_arg,
                    metavar="SITE:KIND[:AT[:ARG]]",
                    help="run the fault-injected resilient round (RandGreedi "
                         "with a survivors merge) under these fault specs; "
                         "at site local.greedy the occurrence index is the "
                         "machine id (e.g. 'local.greedy:drop:1' loses "
                         "machine 1, 'local.greedy:delay:2:0.1' makes "
                         "machine 2 a straggler).  Repeatable.")
    ap.add_argument("--fault-report", default=None, metavar="PATH",
                    help="write the JSON fault report (fired events and "
                         "checks) of the --faults round to PATH")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises without a card")
    return ap


def run(argv=None) -> dict:
    """Parse ``argv``, run the driver, print the ``[im]`` lines, and
    return the result with per-stage seconds and counts (``round``: the
    fixed-theta round's coverages and stage seconds, else None;
    ``guarantee``: OPIM's certified ratio, else None; ``spread_check``:
    each engine's spread and seconds under ``--eval-spread``, else
    None).  With ``--serve``, returns ``serve.run``'s result under
    ``serve``; with ``--faults``, the resilient round's result
    (:func:`_main_faulted`), whose ``rc`` is the exit status."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.fault_report and not args.faults:
        ap.error("--fault-report needs --faults (the resilient round "
                 "is what produces the report)")
    if args.serve:
        from repro_torch.launch import serve
        return dict(serve=serve.run([
            "--graph", args.graph, "--n", str(args.n),
            "--avg-deg", str(args.avg_deg), "--model", args.model,
            "--solver", args.solver, "--sampler", args.sampler,
            "--k-max", str(args.k), "--max-theta", str(args.max_theta),
            "--seed", str(args.seed), "--device", args.device, "--check"]))
    resolve_sampler(args.sampler)
    maxcover.resolve_solver(args.solver)
    cascade.resolve_engine(args.eval_engine)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    g = make_graph(args.graph, args.n, args.avg_deg, args.seed, device)
    graph_s = time.perf_counter() - t0
    n = g.num_vertices
    key = prng.key(args.seed)
    if args.faults:
        return _main_faulted(args, g, key, device, graph_s)
    print(f"[im] graph n={n} m={g.num_edges} model={args.model} "
          f"selector={args.selector}")

    stats: dict = {}
    t0 = time.perf_counter()
    m = args.machines or 1
    solver = args.solver
    if args.selector in ("greediris", "greediris-trunc") and args.theta:
        res = _fixed_theta_round(args, g, m, key, stats)
    else:
        sel = {
            "greedy": lambda: imm.make_greedy_selector(solver),
            "ripples": lambda: imm.make_ripples_selector(m),
            "randgreedi": lambda: imm.make_randgreedi_selector(
                m, "greedy", solver=solver),
            "greediris": lambda: imm.make_randgreedi_selector(
                m, "streaming", args.delta, use_kernel=args.use_kernel,
                solver=solver),
            "greediris-trunc": lambda: imm.make_randgreedi_selector(
                m, "streaming", args.delta, args.alpha,
                use_kernel=args.use_kernel, solver=solver),
        }[args.selector]()
        if args.use_opim:
            res = opim.opim(g, args.k, args.eps, key, model=args.model,
                            selector=sel, max_theta=args.max_theta,
                            sampler=args.sampler, coin_chunk=args.coin_chunk,
                            gather=args.gather, stats=stats)
            print(f"[im] OPIM rounds={res.rounds} theta={res.theta} "
                  f"guarantee={res.guarantee:.3f} "
                  f"sigma_l={res.sigma_lower:.1f}")
        else:
            res = imm.imm(g, args.k, args.eps, key, model=args.model,
                          selector=sel, max_theta=args.max_theta,
                          sampler=args.sampler, coin_chunk=args.coin_chunk,
                          gather=args.gather, stats=stats)
            print(f"[im] IMM rounds={res.rounds} theta={res.theta} "
                  f"coverage_frac={res.coverage_fraction:.4f}")
    elapsed = time.perf_counter() - t0

    seeds = np.asarray(res.seeds)
    k_real = int((seeds >= 0).sum())
    t1 = time.perf_counter()
    spread = float(influence(g, torch.from_numpy(seeds), key.fold_in(99),
                             model=args.model, num_sims=args.eval_sims,
                             engine=args.eval_engine))
    spread_s = time.perf_counter() - t1
    spread_check = (_spread_check(args, g, seeds, key.fold_in(99), device)
                    if args.eval_spread else None)
    ratio = theory.greediris_ratio(args.delta, args.eps,
                                   args.alpha if "trunc" in args.selector
                                   else 1.0)
    print(f"[im] k={k_real} expected influence = {spread:.1f} "
          f"({100 * spread / n:.2f}% of graph) in {elapsed:.2f}s; "
          f"worst-case ratio {ratio:.3f}")
    return dict(
        seeds=seeds, theta=res.theta, rounds=res.rounds,
        coverage_fraction=getattr(res, "coverage_fraction", None),
        guarantee=getattr(res, "guarantee", None), spread=spread, n=n,
        edges=g.num_edges, graph_s=graph_s,
        sample_s=stats.get("sample_s", 0.0),
        select_s=stats.get("select_s", 0.0), spread_s=spread_s,
        bfs_steps=stats.get("bfs_steps", 0), spread_check=spread_check,
        round=(dict(coverage=res.coverage,
                    global_coverage=res.global_coverage,
                    best_local_coverage=res.best_local_coverage,
                    seconds={name: stats[f"{name}_s"]
                             for name in _ROUND_STAGES})
               if isinstance(res, RoundResult) else None),
        peak_bytes=_peak_bytes(device))


_ROUND_STAGES = ("sample_shuffle", "senders", "receiver", "merge")


class RoundResult(NamedTuple):
    seeds: np.ndarray
    coverage_fraction: float
    theta: int
    rounds: int
    coverage: int
    global_coverage: int
    best_local_coverage: int


def _fixed_theta_round(args, g, m: int, key, stats: dict) -> RoundResult:
    """The reference's ``--theta`` path: one distributed round of m
    machines (``greediris.build_round``) on the graph's device."""
    nbr, prob, wt, fwd, lt = graph_tables(g, args.sampler, args.gather,
                                          args.model)
    alpha = args.alpha if args.selector == "greediris-trunc" else 1.0
    fn, _, theta = greediris.build_round(
        m=m, n=g.num_vertices, theta=args.theta, k=args.k,
        max_degree=g.max_in_degree(), model=args.model, delta=args.delta,
        alpha_trunc=alpha, aggregate=args.aggregate,
        use_kernel=args.use_kernel, solver=args.solver,
        chunk_size=args.chunk_size, sampler=args.sampler,
        fwd=fwd, coin_chunk=args.coin_chunk, gather=args.gather, lt=lt)
    out = fn(nbr, prob, wt, key, stats=stats)
    stats["sample_s"] = stats["sample_shuffle_s"]
    stats["select_s"] = (stats["senders_s"] + stats["receiver_s"]
                         + stats["merge_s"])
    cov = int(out.coverage)
    print(f"[im] m={m} theta={theta} coverage={cov} "
          f"(global {int(out.global_coverage)}, best-local "
          f"{int(out.best_local_coverage)})")
    return RoundResult(out.seeds.cpu().numpy(), cov / theta, theta, 1, cov,
                       int(out.global_coverage),
                       int(out.best_local_coverage))


def _spread_check(args, g, seeds, eval_key, device) -> dict:
    """The spread of ``seeds`` with each cascade engine on the same key;
    raises unless the three are one value.  Returns each engine's spread
    and seconds."""
    values, seconds = {}, {}
    for eng in cascade.ENGINES:
        with StageClock(seconds, eng, device):
            values[eng] = float(influence(
                g, torch.from_numpy(seeds), eval_key, model=args.model,
                num_sims=args.eval_sims, engine=eng))
    if len(set(values.values())) != 1:
        raise AssertionError(f"the cascade engines disagree: {values}")
    print("[im] spread cross-check: " + "  ".join(
        f"{e}={v:.2f}" for e, v in values.items()) + "  (bit-identical)")
    return dict(spread=values, seconds=seconds)


def _main_faulted(args, g, key, device, graph_s: float) -> dict:
    """The ``--faults`` path: one fixed-theta RandGreedi round through
    :func:`repro_torch.runtime.faults.resilient_randgreedi`.  Injected
    machine failures become a survivors merge (equal to a round on the
    survivors alone), injected stragglers shrink the truncation knob
    through the StragglerMonitor.  Returns the seeds, survivors,
    ``alpha_used``, coverage, spread, stage seconds and ``rc`` (1 when
    every machine was lost, the report written all the same)."""
    n = g.num_vertices
    m = args.machines or 1
    theta = args.theta or 1024
    stats: dict = {}
    with StageClock(stats, "sample_s", device):
        nbr, prob, wt, fwd, lt = graph_tables(g, args.sampler, args.gather,
                                              args.model)
        rows = rrr.sample_incidence(
            nbr, prob, wt, key.fold_in(1), theta=theta, n=n,
            model=args.model, sampler=args.sampler, fwd=fwd,
            coin_chunk=args.coin_chunk, gather=args.gather, lt=lt)
    plan = faults.FaultPlan(args.faults)
    monitor = StragglerMonitor()
    alpha0 = args.alpha if "trunc" in args.selector else 1.0
    print(f"[im] resilient round: n={n} theta={theta} m={m} "
          f"k={args.k} faults={len(plan.specs)}")
    report = faults.FaultReport()
    out = dict(n=n, edges=g.num_edges, theta=theta, graph_s=graph_s,
               stats=stats)
    try:
        with StageClock(stats, "round_s", device):
            res, survivors, alpha_used = faults.resilient_randgreedi(
                rows, key.fold_in(2), m=m, k=args.k, plan=plan,
                monitor=monitor, delta=args.delta, alpha_trunc=alpha0,
                solver=args.solver)
    except faults.PartitionsLostError as e:
        print(f"[im] FATAL: {e}", file=sys.stderr)
        report.add_events(plan)
        report.check("round_survived", False, error=str(e))
        if args.fault_report:
            report.write(args.fault_report)
        return dict(out, rc=1, seeds=None, survivors=(), alpha_used=None,
                    coverage=None, spread=None,
                    straggler_flags=monitor.flags,
                    peak_bytes=_peak_bytes(device))
    del rows
    seeds = res.seeds.cpu().numpy()
    t1 = time.perf_counter()
    spread = float(influence(g, torch.from_numpy(seeds), key.fold_in(99),
                             model=args.model, num_sims=args.eval_sims,
                             engine=args.eval_engine))
    stats["spread_s"] = time.perf_counter() - t1
    lost = m - len(survivors)
    print(f"[im] survivors={len(survivors)}/{m} (lost {lost}) "
          f"alpha={alpha0}->{alpha_used} "
          f"coverage={int(res.coverage)} spread={spread:.1f} "
          f"({100 * spread / n:.2f}% of graph) in {stats['round_s']:.2f}s")
    report.add_events(plan)
    report.check("round_survived", True, survivors=len(survivors),
                 lost=lost, coverage=int(res.coverage),
                 spread=spread, alpha_used=alpha_used,
                 straggler_flags=monitor.flags)
    if args.fault_report:
        report.write(args.fault_report)
        print(f"[im] fault report -> {args.fault_report}")
    return dict(out, rc=0, seeds=seeds, survivors=survivors,
                alpha_used=alpha_used, coverage=int(res.coverage),
                spread=spread, straggler_flags=monitor.flags,
                peak_bytes=_peak_bytes(device))


def _peak_bytes(device):
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)


def main(argv=None) -> int:
    out = run(argv)
    return out["serve"]["rc"] if "serve" in out else out.get("rc", 0)


if __name__ == "__main__":
    raise SystemExit(main())
