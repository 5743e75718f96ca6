"""The selector calls' share of their bound: each call's incidence
[n, W] read once and its outputs written once over the HBM rate, over
the device time inside the calls."""


def read(run):
    tr = run.trace
    bound = run.counts.get("select_bound_s")
    if tr is None or bound is None:
        return None
    spent = tr.device_s(within=tr.named("portbench.selector"))
    return 100.0 * bound / spent if spent > 0 else None
