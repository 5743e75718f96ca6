"""Seconds a selection spends on the padded tables ``imm`` builds every
call: the union of the program's ``repro_torch.tables.*`` spans (the
reverse table's scatters enqueued, the forward table built on the host
and copied to the card) over the window's selections."""
from portbench import spans


def read(run):
    tr = run.trace
    if tr is None or not run.units:
        return None
    got = spans.program(tr, "tables.", prefix=True)
    if not got:
        return None
    return spans.union_s(got) / run.units
