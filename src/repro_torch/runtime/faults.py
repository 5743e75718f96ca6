"""Deterministic fault injection and the resilient RandGreedi round —
the port's own copy of ``repro.runtime.faults`` (the reference module is
stdlib only at import time; the port copies it rather than importing
it).

* :class:`FaultPlan` — a deterministic schedule of faults at named
  injection sites (``SITES``).  Each spec fires on one occurrence of its
  site (one counter per site, advanced on every probe), so an injected
  replay is exactly reproducible.  Kinds: ``raise`` (raise
  :class:`InjectedFault`), ``delay`` (sleep ``arg`` seconds through the
  plan's injectable ``sleep_fn``), and ``nan`` / ``drop`` /
  ``write_fail``, which the caller interprets.
* :func:`resilient_randgreedi` — the fault-tolerant round: probe each
  machine's local greedy under the plan, drop dead and poisoned
  machines, and merge only the survivors through
  ``randgreedi_maxcover(survivors=...)``, bit-identical to a round on
  those machines alone.  Persistent stragglers shrink the truncation
  knob ``alpha`` through ``StragglerMonitor.suggest_alpha``.
* :class:`FaultReport` — the JSON fault report: fired events plus named
  pass/fail checks.

Sites (callers pass the plan explicitly — no globals):

  ==================  =================================================
  sampler.slab_fill   repro_torch.core.service._sample_slabs (per slab)
  local.greedy        per-machine local greedy (resilient_randgreedi;
                      occurrence index == machine id within a round)
  receiver.insert     the receiver-side merge (resilient_randgreedi)
  checkpoint.write    repro_torch.checkpoint.store.CheckpointStore._write
  service.admit       InfluenceService.admit (per query)
  service.answer      InfluenceService.answer (per batch)
  ==================  =================================================

Nothing here imports torch at import time (the round imports it when
called), so ``checkpoint.store`` depends on this module without cycles.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Optional, Sequence

FAULT_KINDS = ("raise", "nan", "delay", "drop", "write_fail")

SITES = (
    "sampler.slab_fill",
    "local.greedy",
    "receiver.insert",
    "checkpoint.write",
    "service.admit",
    "service.answer",
)

# Which kinds make sense at which sites (validated at parse time so a
# CLI typo fails at the argparse boundary, not mid-replay).
KIND_SITES = {
    "raise": SITES,
    "delay": SITES,
    "nan": ("local.greedy",),
    "drop": ("local.greedy",),
    "write_fail": ("checkpoint.write",),
}


class InjectedFault(RuntimeError):
    """An injected failure fired by a :class:`FaultPlan` spec."""

    def __init__(self, site: str, kind: str, occurrence: int):
        super().__init__(
            f"injected {kind} at {site} (occurrence {occurrence})")
        self.site = site
        self.kind = kind
        self.occurrence = occurrence


class PartitionsLostError(RuntimeError):
    """Every partition of a round was lost — nothing left to merge."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire ``kind`` on the ``at``-th occurrence
    of ``site`` (0-based).  ``arg`` is the delay in seconds for
    ``kind="delay"`` (unused otherwise)."""
    site: str
    kind: str
    at: int = 0
    arg: float = 0.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown injection site {self.site!r}; expected one "
                f"of {SITES}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{FAULT_KINDS}")
        if self.site not in KIND_SITES[self.kind]:
            raise ValueError(
                f"fault kind {self.kind!r} does not apply at site "
                f"{self.site!r} (valid sites: {KIND_SITES[self.kind]})")
        if self.at < 0:
            raise ValueError(f"occurrence index must be >= 0, got "
                             f"{self.at}")
        if self.arg < 0:
            raise ValueError(f"fault arg must be >= 0, got {self.arg}")


def parse_fault(text: str) -> FaultSpec:
    """Parse a ``site:kind[:at[:arg]]`` spec string, e.g.
    ``service.answer:raise:1`` or ``local.greedy:delay:2:0.05``."""
    parts = text.split(":")
    if not 2 <= len(parts) <= 4:
        raise ValueError(
            f"expected 'site:kind[:at[:arg]]', got {text!r} (e.g. "
            "'checkpoint.write:write_fail:0' or "
            "'local.greedy:delay:1:0.05')")
    site, kind = parts[0], parts[1]
    try:
        at = int(parts[2]) if len(parts) > 2 else 0
    except ValueError:
        raise ValueError(
            f"occurrence index must be an integer, got {parts[2]!r} "
            f"in {text!r}") from None
    try:
        arg = float(parts[3]) if len(parts) > 3 else 0.0
    except ValueError:
        raise ValueError(
            f"fault arg must be a number, got {parts[3]!r} in "
            f"{text!r}") from None
    return FaultSpec(site, kind, at, arg)


def cli_fault_arg(text: str) -> FaultSpec:
    """argparse ``type=`` validator for ``--inject`` / ``--faults``:
    fail at the CLI boundary with an actionable message instead of a
    deep ValueError mid-replay."""
    try:
        return parse_fault(text)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None


class FaultPlan:
    """A deterministic fault schedule.

    The plan keeps one occurrence counter per site; every
    :meth:`fire` probe advances the site's counter and fires every
    spec whose ``at`` equals the previous count.  ``sleep_fn`` is
    injectable so delay faults (and their tests) never block on real
    ``time.sleep``.
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), *,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.specs = tuple(specs)
        for s in self.specs:
            if not isinstance(s, FaultSpec):
                raise TypeError(f"expected FaultSpec, got {type(s)}")
        self.sleep_fn = sleep_fn
        self._counts: dict[str, int] = {}
        self.events: list[dict] = []

    def occurrences(self, site: str) -> int:
        """How many times ``site`` has been probed so far."""
        return self._counts.get(site, 0)

    def fire(self, site: str, **context) -> Optional[FaultSpec]:
        """Probe ``site``: advance its occurrence counter and fire the
        matching spec, if any.

        ``raise`` specs raise :class:`InjectedFault`; ``delay`` specs
        sleep ``arg`` seconds and return the spec; ``nan`` / ``drop``
        / ``write_fail`` specs are returned for the caller to
        interpret.  Returns ``None`` when nothing fires.
        """
        if site not in SITES:
            raise ValueError(f"unknown injection site {site!r}")
        i = self._counts.get(site, 0)
        self._counts[site] = i + 1
        hit = None
        for spec in self.specs:
            if spec.site == site and spec.at == i:
                hit = spec
                break
        if hit is None:
            return None
        self.events.append({"site": site, "kind": hit.kind,
                            "occurrence": i, "arg": hit.arg,
                            **context})
        if hit.kind == "raise":
            raise InjectedFault(site, hit.kind, i)
        if hit.kind == "delay":
            self.sleep_fn(hit.arg)
        return hit

    def report(self) -> dict:
        return {
            "specs": [dataclasses.asdict(s) for s in self.specs],
            "events": list(self.events),
        }


def fire(plan: Optional[FaultPlan], site: str,
         **context) -> Optional[FaultSpec]:
    """``plan.fire`` with a no-op fallback for ``plan=None`` — the
    injection sites stay zero-cost on the happy path."""
    if plan is None:
        return None
    return plan.fire(site, **context)


class FaultReport:
    """The JSON fault report: fired events + named checks."""

    def __init__(self):
        self.checks: list[dict] = []
        self.events: list[dict] = []
        self.merged: list[dict] = []

    def check(self, name: str, passed: bool, **detail) -> bool:
        self.checks.append({"name": name, "pass": bool(passed),
                            **detail})
        return bool(passed)

    def add_events(self, plan: Optional[FaultPlan]):
        if plan is not None:
            self.events.extend(plan.events)

    @property
    def ok(self) -> bool:
        mine = all(c["pass"] for c in self.checks)
        them = all(m.get("pass", True) for m in self.merged)
        return mine and them

    def merge_file(self, path: str):
        """Fold another fault report (e.g. the serve replay's) into
        this one's ``merged`` section, so one file holds both."""
        with open(path) as f:
            self.merged.append(json.load(f))

    def to_dict(self) -> dict:
        return {"pass": self.ok, "checks": self.checks,
                "events": self.events, "merged": self.merged}

    def write(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")


def resilient_randgreedi(rows, key, *, m: int, k: int,
                         plan: Optional[FaultPlan] = None,
                         monitor=None, aggregator: str = "streaming",
                         delta: float = 0.077,
                         alpha_trunc: float = 1.0,
                         solver: str = "scan",
                         clock: Callable[[], float] = time.monotonic,
                         merge_retries: int = 2):
    """Fault-tolerant RandGreedi round over packed rows int32 ``[n, W]``.

    Probes each of the m per-machine local greedy solves under ``plan``
    (site ``local.greedy``; occurrence index == machine id): a
    ``raise``/``drop`` kills the machine, a ``nan`` poisons its gains
    (caught by the finiteness check, and the machine is dropped), a
    ``delay`` makes it a straggler (observed by ``monitor``, a
    :class:`~repro_torch.runtime.fault_tolerance.StragglerMonitor`).
    The merge runs over only the surviving partitions through
    ``randgreedi_maxcover(survivors=...)``: the partition depends only
    on ``(n, m, key)``, so the result equals a round on the m'
    survivors from scratch.  The merge is probed at ``receiver.insert``
    and retried up to ``merge_retries`` times on an injected raise.

    Returns ``(result, survivors, alpha_used)``; raises
    :class:`PartitionsLostError` when every machine is lost.
    """
    import numpy as np
    import torch

    from repro_torch.core import maxcover, randgreedi

    assign = randgreedi.partition_blocks(rows.shape[0], m, key)
    dead: set[int] = set()
    for j in range(m):
        t0 = clock()
        try:
            spec = fire(plan, "local.greedy", machine=j)
        except InjectedFault:
            dead.add(j)
            continue
        if spec is not None and spec.kind == "drop":
            dead.add(j)
            continue
        block = torch.from_numpy(assign[j]).to(rows.device).long()
        sol = maxcover.greedy_maxcover(rows[block], k, solver=solver)
        gains = sol.gains.cpu().numpy().astype(np.float64)
        if spec is not None and spec.kind == "nan":
            gains = np.full_like(gains, np.nan)  # poisoned payload
        if monitor is not None:
            monitor.observe(clock() - t0)
        if not np.isfinite(gains).all():
            dead.add(j)
            continue
    survivors = tuple(j for j in range(m) if j not in dead)
    if not survivors:
        raise PartitionsLostError(
            f"all {m} partitions lost — cannot merge (injected plan: "
            f"{plan.specs if plan else ()})")

    alpha_used = alpha_trunc
    if monitor is not None:
        alpha_used = monitor.suggest_alpha(alpha_trunc)

    last: Optional[InjectedFault] = None
    for _ in range(merge_retries + 1):
        try:
            fire(plan, "receiver.insert", survivors=len(survivors))
        except InjectedFault as e:
            last = e
            continue
        # A kept fault's traceback holds this frame, and so ``rows``,
        # until the cycle collector runs: drop it.
        last = None
        res = randgreedi.randgreedi_maxcover(
            rows, key, m=m, k=k, aggregator=aggregator, delta=delta,
            alpha_trunc=alpha_used, solver=solver, survivors=survivors)
        return res, survivors, alpha_used
    raise last  # the merge kept failing past the retry budget
