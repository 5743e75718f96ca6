"""The LT push's share of its bound over the window: the least traffic
its steps need (``lt_counts.bound_s``, from the program's counters) over
the device time of ``push_lt_kernel`` in the program's
``repro_torch.rrr.step`` spans."""
from portbench import lt_counts, spans


def read(run):
    tr = run.trace
    bound = lt_counts.bound_s(run.stats)
    if tr is None or bound is None:
        return None
    steps = spans.program(tr, "rrr.step")
    if not steps:
        return None
    spent = tr.device_s(within=steps, names=["push_lt_kernel"])
    return 100.0 * bound / spent if spent > 0 else None
