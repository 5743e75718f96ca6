"""The program's own spans (``repro_torch.<layer>.<phase>``) in a traced
run.  ``Trace`` files them with the host's operations; where the
profiler also records a span's range on the device (from the first to
the last operation the span launched), that copy is told apart by its
ends, which are the start of one device operation and the end of
another."""
from __future__ import annotations

PREFIX = "repro_torch."


def program(tr, name: str, prefix: bool = False) -> list:
    """The host's spans ``repro_torch.<name>`` (with ``prefix``, every
    span whose name starts so) that start inside the traced window,
    by start."""
    full = PREFIX + name
    starts = {d.start for d in tr.device}
    ends = {d.end for d in tr.device}
    lo, hi = tr.window.start, tr.window.end
    return sorted((h for h in tr.host
                   if (h.name.startswith(full) if prefix else h.name == full)
                   and lo <= h.start <= hi
                   and not (h.start in starts and h.end in ends)),
                  key=lambda h: h.start)


def union_s(spans) -> float:
    """Seconds the intervals cover, each instant once."""
    total, end = 0.0, float("-inf")
    for s in sorted(spans, key=lambda s: s.start):
        if s.end > end:
            total += s.end - max(s.start, end)
            end = s.end
    return total
