"""Online influence service driver (twin of ``repro.launch.serve``):
replay a query trace against the resident sketch pool
(``repro_torch.core.service``) on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --n 256 --queries 16 \
      --batch 8 --solver resident --check --device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --graph er --n 262144 \
      --avg-deg 4 --model IC --sampler kernel --theta0 32768 \
      --max-theta 131072 --slab 4096 --queries 32 --batch 8 --k-max 100 \
      --refresh-every 1 --solver lazy --check

Same flags and ``[serve]`` lines as the reference, plus ``--device``
(default ``cuda``; it never falls back to the CPU).  ``--sampler``
defaults to ``kernel`` here (the reference's default is ``dense``); all
three samplers give the same pool bits.

The trace is a deterministic mix of (k, seed-constraint, budget)
queries, admitted in batches of ``--batch`` (one batched solve per
batch and generation over the shared pool).  ``--check`` replays every
query through the sequential ``answer_one`` and exits non-zero unless
every batched answer is identical.  ``--refresh-every`` refreshes the
pool between batches with the next batch's tickets already admitted,
so they drain on their old generation.

``--recover`` runs the supervised replay: the pool is snapshotted to a
checkpoint store before every batch, ``--inject site:kind[:at[:arg]]``
faults fire deterministically, and a fault that outlives the retry
budget escalates to restore-from-snapshot and re-answer.
``--kill-after N`` stops after N batches; ``--resume-from N`` restores
the newest snapshot and resumes at batch N.  With ``--check`` the
supervised answers must equal a clean full replay's; ``--fault-report``
writes the JSON report.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from typing import Optional

import numpy as np

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core import prng, resolve_device
from repro_torch.core import service as svc
from repro_torch.core.service import (InfluenceService, Query,
                                      answer_with_retry, restore_pool,
                                      snapshot_pool)
from repro_torch.launch.im_driver import make_graph
from repro_torch.runtime import faults
from repro_torch.runtime.faults import FaultPlan, InjectedFault


def make_trace(n: int, num_queries: int, seed: int, *, k_max: int = 8,
               excl_max: int = 6, budget_frac: float = 0.25) -> list[Query]:
    """Deterministic query trace (the reference's numpy draws): mixed k,
    mixed-length exclusion sets, and a sprinkle of spread budgets."""
    rng = np.random.default_rng(seed)
    trace = []
    for _ in range(num_queries):
        k = int(rng.integers(1, k_max + 1))
        e = int(rng.integers(0, excl_max + 1))
        excluded = tuple(int(v) for v in
                         rng.choice(n, size=e, replace=False)) if e else ()
        budget = (float(rng.uniform(1.0, budget_frac * n))
                  if rng.random() < 0.3 else None)
        trace.append(Query(k=k, excluded=excluded, budget=budget))
    return trace


def replay(service: InfluenceService, trace: list[Query], *, batch: int,
           refresh_every: int = 0):
    """Admit and answer the trace in batches -> (answers,
    pools-by-generation, elapsed seconds).  With ``refresh_every`` > 0 a
    refresh follows every that-many batches' admission, so those tickets
    drain on their old generation.  The returned pools keep every
    generation that answered alive for ``--check``."""
    answers = []
    pools = {}
    t0 = time.perf_counter()
    for i in range(0, len(trace), batch):
        tickets = [service.admit(q) for q in trace[i:i + batch]]
        if refresh_every and (i // batch + 1) % refresh_every == 0 \
                and service.pool.theta < service.max_theta:
            service.refresh()          # tickets drain on the old tag
        for t in tickets:
            pools[t.generation] = service._pools[t.generation]
        answers.extend(service.answer(tickets))
    return answers, pools, time.perf_counter() - t0


def check_bit_identity(service: InfluenceService, pools: dict,
                       trace: list[Query], answers: list) -> int:
    """Replay each query through the sequential ``answer_one`` on the
    generation that answered it; count mismatches."""
    mismatches = 0
    for q, a in zip(trace, answers):
        ref = svc.answer_one(pools[a.generation], q, solver=service.solver,
                             delta=service.delta, alpha=service.alpha)
        same = (np.array_equal(a.seeds, ref.seeds)
                and a.k_used == ref.k_used and a.coverage == ref.coverage
                and a.sigma_lower == ref.sigma_lower
                and a.sigma_upper == ref.sigma_upper)
        if not same:
            mismatches += 1
            print(f"[serve] MISMATCH k={q.k} excluded={q.excluded} "
                  f"budget={q.budget}: batched seeds={a.seeds} "
                  f"cov={a.coverage} vs sequential seeds={ref.seeds} "
                  f"cov={ref.coverage}", file=sys.stderr)
    return mismatches


# ---------------------------------------------------------------------
# Supervised replay: snapshot / inject / recover / resume
# ---------------------------------------------------------------------

def _snapshot_with_retry(store: CheckpointStore, pool, *, retries: int,
                         backoff_s: float, sleep_fn) -> int:
    """Blocking snapshot with bounded retry; a failed write is
    acknowledged (``clear_error``) and retried."""
    last: Optional[Exception] = None
    for attempt in range(retries + 1):
        if attempt and backoff_s:
            sleep_fn(backoff_s * (2 ** (attempt - 1)))
        try:
            return snapshot_pool(store, pool)
        except (InjectedFault, OSError) as e:
            store.clear_error()
            last = e
    raise last  # type: ignore[misc]


def _admit_with_retry(service: InfluenceService, queries, *, retries: int,
                      backoff_s: float, sleep_fn):
    """Admit a batch, releasing partial admissions and retrying on an
    injected admit fault."""
    last: Optional[Exception] = None
    for attempt in range(retries + 1):
        if attempt and backoff_s:
            sleep_fn(backoff_s * (2 ** (attempt - 1)))
        tickets = []
        try:
            for q in queries:
                tickets.append(service.admit(q))
            return tickets
        except InjectedFault as e:
            service.release(tickets)
            last = e
    raise last  # type: ignore[misc]


def supervised_replay(g, key, trace: list[Query], *, batch: int,
                      store: CheckpointStore,
                      plan: Optional[FaultPlan] = None,
                      refresh_every: int = 0, retries: int = 2,
                      backoff_s: float = 0.0, sleep_fn=time.sleep,
                      start_batch: int = 0, stop_after: int = 0,
                      theta0: int = 512, max_theta: int = 1 << 12,
                      slab: int = 256, solver: str = "resident",
                      model: str = "IC", sampler: str = "kernel"):
    """Replay ``trace`` under supervision: per batch ``refresh
    (scheduled) -> snapshot -> admit -> answer``, transient faults
    retried, an exhausted retry budget escalated to
    restore-from-snapshot.  ``start_batch`` > 0 restores the newest
    snapshot and resumes there; ``stop_after`` bounds the batches (the
    kill).  Returns ``(answers, service, {"recoveries", "batches"})``."""
    num_batches = (len(trace) + batch - 1) // batch
    end = (min(num_batches, start_batch + stop_after) if stop_after
           else num_batches)
    if start_batch == 0:
        service = InfluenceService(
            g, key, theta0=theta0, max_theta=max_theta, slab=slab,
            solver=solver, model=model, sampler=sampler, fault_plan=plan)
    else:
        pool, step = restore_pool(store, g)
        if pool is None:
            raise FileNotFoundError(
                f"--resume-from {start_batch} but no snapshot in "
                f"{store.root}")
        service = InfluenceService.from_pool(
            pool, theta0=theta0, max_theta=max_theta, solver=solver,
            fault_plan=plan)
    answers: list = []
    recoveries = 0
    for bi in range(start_batch, end):
        queries = trace[bi * batch:(bi + 1) * batch]
        do_refresh = bool(refresh_every and bi and bi % refresh_every == 0)
        for attempt in (0, 1):
            try:
                if do_refresh and service.pool.theta < service.max_theta:
                    service.refresh()
                do_refresh = False
                if service.pool.theta:
                    _snapshot_with_retry(store, service.pool,
                                         retries=retries,
                                         backoff_s=backoff_s,
                                         sleep_fn=sleep_fn)
                tickets = _admit_with_retry(service, queries,
                                            retries=retries,
                                            backoff_s=backoff_s,
                                            sleep_fn=sleep_fn)
                answers.extend(answer_with_retry(
                    service, tickets, retries=retries,
                    backoff_s=backoff_s, sleep_fn=sleep_fn))
                break
            except (InjectedFault, svc.StaleGenerationError):
                # Retry budget spent: rebuild the service from the newest
                # snapshot and re-answer the batch (deterministic, so
                # the answers equal the clean replay's).
                if attempt:
                    raise
                pool, _ = restore_pool(store, g)
                if pool is None:
                    raise
                service = InfluenceService.from_pool(
                    pool, theta0=theta0, max_theta=max_theta, solver=solver,
                    fault_plan=plan)
                recoveries += 1
    return answers, service, {"recoveries": recoveries,
                              "batches": end - start_batch}


def answers_equal(a, b) -> bool:
    """Two answers equal in their seeds and every scalar field (floats
    compared exactly)."""
    return bool(np.array_equal(a.seeds, b.seeds) and a[1:] == b[1:])


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="er", choices=("er", "ba", "rmat"))
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--avg-deg", type=float, default=6.0)
    ap.add_argument("--model", default="IC", choices=("IC", "LT"))
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8,
                    help="concurrent queries per batched solve")
    ap.add_argument("--k-max", type=int, default=8)
    ap.add_argument("--solver", default="resident",
                    choices=("scan", "fused", "resident", "lazy"))
    ap.add_argument("--sampler", default="kernel",
                    choices=("dense", "packed", "kernel"),
                    help="pool sampler ('kernel': the CUDA coin and "
                         "expansion kernels); all three give the same bits")
    ap.add_argument("--theta0", type=int, default=512)
    ap.add_argument("--max-theta", type=int, default=1 << 12)
    ap.add_argument("--slab", type=int, default=256)
    ap.add_argument("--refresh-every", type=int, default=0,
                    help="refresh the pool after every N batches, with "
                         "that batch's tickets draining on the old "
                         "generation (0 = never)")
    ap.add_argument("--check", action="store_true",
                    help="replay every query through the sequential "
                         "answer_one and exit non-zero on any mismatch; "
                         "with --recover, compare against a clean full "
                         "replay instead")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inject", action="append", default=[],
                    type=faults.cli_fault_arg, metavar="SITE:KIND[:AT[:ARG]]",
                    help="inject a deterministic fault (repeatable); "
                         f"sites: {', '.join(faults.SITES)}; kinds: "
                         f"{', '.join(faults.FAULT_KINDS)}. "
                         "Requires --recover.")
    ap.add_argument("--recover", action="store_true",
                    help="supervised replay: snapshot the pool before "
                         "every batch and restore+re-answer when a fault "
                         "outlives the retry budget")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory for --recover (default: a "
                         "fresh temp dir)")
    ap.add_argument("--kill-after", type=int, default=0,
                    help="process only this many batches then stop")
    ap.add_argument("--resume-from", type=int, default=0,
                    help="restore the newest snapshot from --ckpt-dir and "
                         "resume the trace at this batch index")
    ap.add_argument("--retries", type=int, default=2,
                    help="per-stage retry budget in supervised mode")
    ap.add_argument("--backoff", type=float, default=0.0,
                    help="base retry backoff seconds (doubles per attempt)")
    ap.add_argument("--fault-report", default=None, metavar="PATH",
                    help="write the JSON fault report to PATH")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises without a card")
    return ap


def run(argv=None) -> dict:
    """Parse ``argv``, run the replay, print the ``[serve]`` lines, and
    return ``rc`` (the exit code) with the run's numbers: answers,
    generations, certified count, elapsed seconds, the service's
    ``stats`` (batched solve and refresh seconds and counts), the
    service itself and the trace."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.inject and not args.recover:
        ap.error("--inject requires --recover (the supervised replay "
                 "is what recovers from the injected faults)")
    if (args.kill_after or args.resume_from) and not args.recover:
        ap.error("--kill-after/--resume-from require --recover")
    if args.kill_after < 0 or args.resume_from < 0:
        ap.error("--kill-after/--resume-from must be >= 0")
    if args.resume_from and not args.ckpt_dir:
        ap.error("--resume-from needs --ckpt-dir (the directory the "
                 "killed replay left its snapshots in)")
    if args.retries < 0:
        ap.error("--retries must be >= 0")
    device = resolve_device(args.device)

    g = make_graph(args.graph, args.n, args.avg_deg, args.seed, device)
    trace = make_trace(g.num_vertices, args.queries, args.seed + 1,
                       k_max=args.k_max)
    if args.recover:
        return _run_supervised(args, g, trace)
    stats: dict = {}
    service = InfluenceService(
        g, prng.key(args.seed), theta0=args.theta0,
        max_theta=args.max_theta, slab=args.slab, solver=args.solver,
        model=args.model, sampler=args.sampler, stats=stats)
    print(f"[serve] graph n={g.num_vertices} m={g.num_edges} "
          f"solver={args.solver} trace={len(trace)} queries "
          f"(batch={args.batch})")

    answers, pools, elapsed = replay(service, trace, batch=args.batch,
                                     refresh_every=args.refresh_every)
    gens = sorted({a.generation for a in answers})
    certified = sum(a.certified for a in answers)
    state = svc.per_query_state_bytes(service.pool.words, args.k_max,
                                      max(len(q.excluded) for q in trace))
    print(f"[serve] {len(answers)} answers in {elapsed:.2f}s "
          f"({len(answers) / max(elapsed, 1e-9):.1f} queries/s)  "
          f"generations={gens} theta={service.pool.theta} "
          f"certified={certified}/{len(answers)} "
          f"per-query-state={state}B")
    out = dict(rc=0, answers=answers, generations=gens,
               certified=certified, theta=service.pool.theta,
               elapsed_s=elapsed, stats=dict(stats), mismatches=None,
               service=service, trace=trace)
    if args.check:
        bad = check_bit_identity(service, pools, trace, answers)
        out["mismatches"] = bad
        if bad:
            print(f"[serve] FAIL: {bad}/{len(trace)} batched answers "
                  f"differ from the sequential reference", file=sys.stderr)
            out["rc"] = 1
            return out
        print(f"[serve] check OK: all {len(trace)} batched answers "
              f"bit-identical to the sequential reference")
    return out


def _run_supervised(args, g, trace) -> dict:
    """The --recover path: supervised replay under the injected fault
    plan, optional kill/resume, the clean-replay check, the report."""
    plan = FaultPlan(args.inject) if args.inject else None
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="serve_ckpt_")
    cfg = dict(batch=args.batch, refresh_every=args.refresh_every,
               theta0=args.theta0, max_theta=args.max_theta, slab=args.slab,
               solver=args.solver, model=args.model, sampler=args.sampler)
    print(f"[serve] supervised replay: {len(args.inject)} fault "
          f"spec(s), ckpt={ckpt}, resume_from={args.resume_from}, "
          f"kill_after={args.kill_after or 'never'}")
    answers, service, stats = supervised_replay(
        g, prng.key(args.seed), trace,
        store=CheckpointStore(ckpt, fault_plan=plan), plan=plan,
        retries=args.retries, backoff_s=args.backoff,
        start_batch=args.resume_from, stop_after=args.kill_after, **cfg)
    fired = len(plan.events) if plan else 0
    print(f"[serve] {len(answers)} answers over {stats['batches']} "
          f"batch(es); {fired} fault(s) fired, "
          f"{stats['recoveries']} restore-from-snapshot "
          f"recover(ies); theta={service.pool.theta} "
          f"generation={service.generation}")

    report = faults.FaultReport()
    report.add_events(plan)
    report.check("replay_completed", True, answers=len(answers),
                 recoveries=stats["recoveries"], fired=fired)
    bad = 0
    if args.check:
        with tempfile.TemporaryDirectory() as d:
            ref, _, _ = supervised_replay(
                g, prng.key(args.seed), trace, store=CheckpointStore(d),
                plan=None, **cfg)
        lo = args.resume_from * args.batch
        ref_slice = ref[lo:lo + len(answers)]
        bad = sum(not answers_equal(a, b)
                  for a, b in zip(answers, ref_slice))
        bad += abs(len(answers) - len(ref_slice))
        report.check("bit_identity_vs_clean_replay", bad == 0,
                     mismatches=bad, compared=len(ref_slice))
        if bad:
            print(f"[serve] FAIL: {bad}/{len(ref_slice)} supervised "
                  f"answers differ from the clean replay", file=sys.stderr)
        else:
            print(f"[serve] check OK: all {len(ref_slice)} supervised "
                  f"answers bit-identical to the clean replay")
    if args.fault_report:
        report.write(args.fault_report)
        print(f"[serve] fault report -> {args.fault_report}")
    return dict(rc=1 if bad else 0, answers=answers,
                recoveries=stats["recoveries"], batches=stats["batches"],
                fired=fired, mismatches=bad if args.check else None)


def main(argv=None) -> int:
    return run(argv)["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
