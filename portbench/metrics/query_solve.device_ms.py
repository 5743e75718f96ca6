"""Device milliseconds of the query-axis greedy launches a batch, from
the profiler's trace."""

KERNEL = "greedy_pick_batch"


def read(run):
    tr = run.trace
    if tr is None or not run.units or not tr.has_kernel(KERNEL):
        return None
    return 1e3 * tr.device_s(names=[KERNEL]) / run.units
