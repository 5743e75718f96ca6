"""The query-axis launches' share of their bound: per launch the pool
half read once, each query's exclusions read and its cover, seeds,
gains and selected rows written once, over the HBM rate, over the
launches' device time."""

KERNEL = "greedy_pick_batch"


def read(run):
    tr = run.trace
    bound = run.counts.get("query_bound_s")
    if tr is None or bound is None:
        return None
    spent = tr.device_s(names=[KERNEL])
    return 100.0 * bound / spent if spent > 0 else None
