"""Device milliseconds a selection spends in the sampler's BFS steps:
the operations that start inside the program's ``repro_torch.rrr.step``
spans (each step ends on the host's read of the next word list's
length, so its operations have run), over the window's selections.
The tables, their copies and the incidence's concatenations are left
out."""
from portbench import spans


def read(run):
    tr = run.trace
    if tr is None or not run.units:
        return None
    steps = spans.program(tr, "rrr.step")
    if not steps:
        return None
    return 1e3 * tr.device_s(within=steps) / run.units
