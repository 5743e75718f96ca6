"""The IC sampler's share of its bound in the window's last selection:
the larger of its coins (each visit of a vertex, a coin for each of its
live in-arcs) at OPS_PER_COIN over the INT32 rate and its incidence
written once over the HBM rate, over the device time of that selection
outside its selector calls."""


def read(run):
    tr = run.trace
    bound = run.counts.get("sampler_bound_s_last")
    if tr is None or bound is None:
        return None
    sel = tr.named("portbench.selection")
    if not sel:
        return None
    spent = tr.device_s(within=sel[-1:],
                        without=tr.named("portbench.selector"))
    return 100.0 * bound / spent if spent > 0 else None
