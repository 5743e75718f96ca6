"""Runs one cell of ``BENCHMARK.json`` once and builds its result line.

The cell names a configuration (``configs/<config>.json``, whose
``generator`` is ``graphs/<generator>.py``) and a traffic mix
(``traffic/<traffic>.json``, whose ``entry`` is ``entries/<entry>.py``:
its set-up, window, counts, check and limits).  A ``--trace 1`` run
reads each per-layer metric the cell reports with its reader,
``metrics/<metric>.py`` (``lookup.reader_name``), whose ``read(run)``
returns a number or None (nothing to read).  A new configuration,
generator, mix, entry or metric is a new file and a new entry in
``BENCHMARK.json``: nothing here names one.
"""
from __future__ import annotations

import json
import math
import sys
import time
import types
from pathlib import Path

import torch

from portbench import drive, lookup
from portbench.trace import Trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (or ``names``) whose top-level name is a forbidden
    one, compared whole (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def reader(metric: str):
    return lookup.module("metrics", lookup.reader_name(metric)).read


def quantity(metric: str) -> str:
    """The quantity an end-to-end metric reports: ``selection_s.lt``
    reports ``selection_s`` (a variant holds one quantity to its own
    bound in the cells it lists)."""
    return metric.split(".")[0]


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    def __init__(self, name: str, spec: dict):
        match = [w for w in spec["workloads"] if w["name"] == name]
        if len(match) != 1:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        w = match[0]
        cfg = [c for c in spec["configs"] if c["name"] == w["config"]][0]
        self.config = load_json(ROOT / cfg["file"])
        self.traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
        self.end_to_end = [m for m in spec["end_to_end"]
                           if _listed(m, name)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if _listed(m, name) and m["moves"] in e2e]


def require_kernels(tr: Trace, names) -> None:
    """Fails the traced run when a kernel the cell must launch has no
    event in the trace."""
    missing = [k for k in names if not tr.has_kernel(k)]
    if missing:
        raise RuntimeError(f"the trace holds no event of {missing}")


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        started: float) -> dict:
    """One run -> the result line's object.  ``started`` is the process's
    start on the ``time.perf_counter`` clock."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    entry = drive.entry_class(cell.traffic)(cell.config, cell.traffic,
                                            seed, dev, traced)
    entry.setup()
    entry.warmup()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - started

    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    with drive.span("window", traced):
        got = entry.window(seconds)
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    got["setup_s"] = setup_s
    got["peak_device_gib"] = peak / GIB

    metrics, breakdown, dev_info = {}, None, {}
    if traced:
        tr = Trace.from_profiler(prof) if on_card else None
        del prof
        if tr is not None:
            require_kernels(tr, entry.required_kernels())
            dev_info = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
            breakdown = {"device_ops": tr.device_ops(),
                         "idle_gaps": tr.idle_gaps()}
        ctx = types.SimpleNamespace(trace=tr, stats=entry.stats or {},
                                    units=entry.units, counts=entry.counts(),
                                    cell=cell.name)
        for m in cell.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": got[quantity(m["name"])],
                                  "unit": m["unit"]}
    for name, m in metrics.items():
        if not (isinstance(m["value"], float) or isinstance(m["value"], int))\
                or not math.isfinite(m["value"]):
            raise ValueError(f"{name} read {m['value']!r}")

    t0 = time.perf_counter()
    numbers = entry.verify()
    print(f"[portbench] check {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    attempted, failed = entry.requests()
    limits = entry.LIMITS
    out = {"correct": all(v <= limits[k] for k, v in numbers.items()),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": (torch.cuda.get_device_name(dev) if on_card
                               else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak),
                      **dev_info}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checked"] = {k: {"value": v, "limit": limits[k]}
                      for k, v in numbers.items()}
    return out


def report(out: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error; the result as the last line on standard output."""
    for k, v in out["checked"].items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)

