"""Device milliseconds a selection spends in its selector calls (the
machines' rows, the compact lists and picks, the receiver), from the
profiler's trace."""


def read(run):
    tr = run.trace
    if tr is None or not run.units:
        return None
    spans = tr.named("portbench.selector")
    if not spans:
        return None
    return 1e3 * tr.device_s(within=spans) / run.units
