"""Host milliseconds of a batch's finalisation: the program's
``repro_torch.service.finalize`` spans (the k and budget truncation and
the R2 validation's gathers and OR reductions) over the window's
batches.  The span opens once the solve has run: ``service.solve`` ends
on the blocking copies of the queries' k and budgets from pageable host
memory (``service._limits``), which wait for the stream.  Were those
copies pinned or non-blocking, the solve's device time would fall in
this span."""
from portbench import spans


def read(run):
    tr = run.trace
    if tr is None or not run.units:
        return None
    got = spans.program(tr, "service.finalize")
    if not got:
        return None
    return 1e3 * sum(s.end - s.start for s in got) / run.units
