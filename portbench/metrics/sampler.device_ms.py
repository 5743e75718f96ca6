"""Device milliseconds a selection spends outside its selector calls
(the RRR expansion kernels, the incidence's concatenations and tables),
from the profiler's trace."""


def read(run):
    tr = run.trace
    if tr is None or not run.units:
        return None
    sel = tr.named("portbench.selection")
    if not sel:
        return None
    return 1e3 * tr.device_s(within=sel,
                             without=tr.named("portbench.selector")) \
        / run.units
