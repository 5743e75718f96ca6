"""The traced run's profiler events, read in memory: device operations
(kernels, copies, fills) as intervals, the benchmark's own spans, and the
host operations around them.

Busy time is the union of the device intervals (never their sum, which
counts overlapping work twice); the idle share is one less busy over the
traced window.  Times are seconds on the profiler's clock.
"""
from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

import numpy as np

SPAN_PREFIX = "portbench."
WINDOW = "portbench.window"


class Interval(NamedTuple):
    name: str
    start: float
    end: float


def _ns(e, what: str) -> int:
    """An event's start or duration in ns (older torch gives us)."""
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


def _is_device(e) -> bool:
    """A device operation: not a host event and not a user annotation
    (which torch versions mark by different methods, or not at all)."""
    if "CPU" in str(e.device_type()):
        return False
    if getattr(e, "is_user_annotation", lambda: False)():
        return False
    kind = str(getattr(e, "activity_type", lambda: "")()).lower()
    return "annotation" not in kind and "gpu_user" not in kind


class Trace:
    """Device intervals, spans and host operations of one traced run."""

    def __init__(self, device, spans, host):
        self.device = sorted(device, key=lambda i: i.start)
        self.spans = spans
        self.host = host
        win = self.named(WINDOW)
        if len(win) != 1:
            raise ValueError(f"the trace holds {len(win)} window spans")
        self.window = win[0]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        device, spans, host = [], [], []
        for e in prof.profiler.kineto_results.events():
            start = _ns(e, "start")
            iv = Interval(e.name(), start * 1e-9,
                          (start + _ns(e, "duration")) * 1e-9)
            if iv.name.startswith(SPAN_PREFIX):
                # a span's device-side copy, where torch records one, is
                # no device work
                if "CPU" in str(e.device_type()):
                    spans.append(iv)
            elif _is_device(e):
                device.append(iv)
            else:
                host.append(iv)
        return cls(device, spans, host)

    @property
    def window_s(self) -> float:
        return self.window.end - self.window.start

    def named(self, name: str) -> list[Interval]:
        return sorted((s for s in self.spans if s.name == name),
                      key=lambda s: s.start)

    def _clipped(self):
        lo, hi = self.window.start, self.window.end
        return [(max(d.start, lo), min(d.end, hi)) for d in self.device
                if d.end > lo and d.start < hi]

    def busy_union(self) -> list[tuple[float, float]]:
        """The device's busy intervals inside the window, merged."""
        out: list[list[float]] = []
        for s, e in sorted(self._clipped()):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_union())

    def device_s(self, within=None, without=(), names=None) -> float:
        """Summed device time of the operations that start inside one of
        the intervals ``within`` (default: the window) and inside none
        of ``without``, whose names contain one of ``names`` (None:
        any)."""
        within = [self.window] if within is None else within
        starts = np.array([d.start for d in self.device])

        def inside(spans):
            mask = np.zeros(len(self.device), dtype=bool)
            for s in spans:
                mask |= (starts >= s.start) & (starts <= s.end)
            return mask
        if not len(self.device):
            return 0.0
        mask = inside(within) & ~inside(without)
        total = 0.0
        for d, keep in zip(self.device, mask):
            if keep and (names is None or any(x in d.name for x in names)):
                total += d.end - d.start
        return total

    def has_kernel(self, name: str) -> bool:
        return any(name in d.name for d in self.device)

    def device_ops(self, top: int = 10):
        """[[name, seconds], ...]: the device operations that took most
        time in the window, by name."""
        lo, hi = self.window.start, self.window.end
        tot: dict[str, float] = defaultdict(float)
        for d in self.device:
            if d.start >= lo and d.start <= hi:
                tot[d.name.split("(")[0][:120]] += d.end - d.start
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """[[what the host was doing, seconds], ...]: the window's idle
        device time by the innermost host operation or span under each
        gap's middle, largest first."""
        busy = self.busy_union()
        edges = [self.window.start] + [x for iv in busy for x in iv] \
            + [self.window.end]
        host = sorted((h for h in self.host + self.spans if h.name != WINDOW),
                      key=lambda h: (h.start, -h.end))
        starts = np.array([h.start for h in host])
        # each host operation's innermost enclosing one (a stack sweep)
        parent, stack = [], []
        for i, h in enumerate(host):
            while stack and host[stack[-1]].end < h.start:
                stack.pop()
            parent.append(stack[-1] if stack else -1)
            stack.append(i)
        tot: dict[str, float] = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            i = int(np.searchsorted(starts, mid, "right")) - 1
            while i >= 0 and host[i].end < mid:
                i = parent[i]
            tot[host[i].name[:120] if i >= 0 else "host idle"] += b - a
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:top]]
