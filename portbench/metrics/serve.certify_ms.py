"""Host milliseconds of a batch's certificates: the program's
``repro_torch.service.certify`` spans (each query's OPIM bounds and
answer, on the host) over the window's batches."""
from portbench import spans


def read(run):
    tr = run.trace
    if tr is None or not run.units:
        return None
    got = spans.program(tr, "service.certify")
    if not got:
        return None
    return 1e3 * sum(s.end - s.start for s in got) / run.units
