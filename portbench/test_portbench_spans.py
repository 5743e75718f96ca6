"""The readers of the program's own spans and counters, on a synthetic
trace where each number is exact: the tables' union, the BFS steps'
device time, the service's finalisation and certificates, and the
sampler's live words; each reads nothing where its trace, its spans or
its key are missing."""
import types

import pytest

from portbench import harness, spans
from portbench.trace import Interval, Trace

READERS = ["imm.tables_s", "rrr.device_ms", "rrr.frontier_words",
           "serve.finalize_ms", "serve.certify_ms"]


def _trace(program=True):
    """A window [0, 20] with two selections' table builds, BFS steps and
    a batch's phases; each program span that launched device work has a
    device-side copy (the first operation's start to the last's end),
    as the profiler records on the card."""
    dev = [Interval("Memcpy HtoD", 1.5, 2.5),          # the tables' copy
           Interval("push_ic_kernel", 3.0, 3.5),       # step 1
           Interval("push_ic_kernel", 4.0, 4.25),      # step 2
           Interval("greedy_pick_batch", 9.0, 12.0),   # the solve
           Interval("bitwise_or", 12.5, 12.6),         # finalize
           Interval("bitwise_or", 12.7, 12.75),
           Interval("push_ic_kernel", 21.0, 22.0)]     # after the window
    host = [Interval("aten::cat", 5.0, 5.5)]
    if program:
        host += [
            # selection 1: the reverse table inside nothing, the forward
            # one with its copy inside it, overlapping the reverse
            Interval("repro_torch.tables.reverse", 0.5, 1.25),
            Interval("repro_torch.tables.forward", 1.0, 2.6),
            Interval("repro_torch.tables.forward.copy", 1.4, 2.55),
            Interval("repro_torch.tables.forward.copy", 1.5, 2.5),  # device
            Interval("repro_torch.rrr.step", 2.75, 3.75),
            Interval("repro_torch.rrr.step", 3.8, 4.5),
            Interval("repro_torch.rrr.step", 3.0, 3.5),             # device
            # selection 2's tables
            Interval("repro_torch.tables.reverse", 6.0, 6.5),
            # a batch
            Interval("repro_torch.service.finalize", 12.25, 12.8),
            Interval("repro_torch.service.finalize", 12.5, 12.75),  # device
            Interval("repro_torch.service.certify", 13.0, 13.125),
            # outside the window
            Interval("repro_torch.rrr.step", 20.5, 22.5),
            Interval("repro_torch.tables.forward", 25.0, 26.0)]
    return Trace(dev, [Interval("portbench.window", 0.0, 20.0)], host)


def _run(tr, stats=None, units=2):
    return types.SimpleNamespace(trace=tr, stats={} if stats is None
                                 else stats, units=units, counts={},
                                 cell="c")


def test_the_program_spans_leave_out_their_device_side_copies():
    tr = _trace()
    steps = spans.program(tr, "rrr.step")
    assert [(s.start, s.end) for s in steps] == [(2.75, 3.75), (3.8, 4.5)]
    tables = spans.program(tr, "tables.", prefix=True)
    assert len(tables) == 4
    assert spans.union_s(tables) == pytest.approx(2.1 + 0.5)


def test_each_reader_reads_its_number_from_the_trace():
    run = _run(_trace(), {"frontier_words": 1000, "bfs_steps": 3})
    got = {m: harness.reader(m)(run) for m in READERS}
    assert got["imm.tables_s"] == pytest.approx(2.6 / 2)
    # both steps' kernels (0.5 + 0.25 s), not the copy before them
    assert got["rrr.device_ms"] == pytest.approx(1e3 * 0.75 / 2)
    assert got["rrr.frontier_words"] == pytest.approx(500.0)
    assert got["serve.finalize_ms"] == pytest.approx(1e3 * 0.55 / 2)
    assert got["serve.certify_ms"] == pytest.approx(1e3 * 0.125 / 2)


def test_a_variant_reads_with_the_same_reader():
    run = _run(_trace(), {"frontier_words": 1000})
    for m in ("imm.tables_s", "rrr.device_ms", "rrr.frontier_words"):
        assert harness.reader(m + ".lt")(run) == harness.reader(m)(run)


@pytest.mark.parametrize("metric", READERS)
@pytest.mark.parametrize("missing", ["trace", "spans", "key", "units"])
def test_a_reader_reads_nothing_where_its_input_is_missing(metric, missing):
    stats = {} if missing == "key" else {"frontier_words": 7}
    tr = {"trace": None, "spans": _trace(program=False)}.get(missing,
                                                             _trace())
    run = _run(tr, stats, units=0 if missing == "units" else 2)
    got = harness.reader(metric)(run)
    counter = metric == "rrr.frontier_words"
    if counter and missing in ("trace", "spans"):
        assert got == pytest.approx(3.5)        # a counter needs no trace
    elif not counter and missing == "key":
        assert got is not None and got > 0      # a span needs no counter
    else:
        assert got is None



@pytest.mark.parametrize("host_end, late", [
    (4.0, "repro_torch.service.finalize"),    # the copy nests in its span
    (2.5, "repro_torch.service.finalize")])   # the copy outlasts its span
def test_idle_gaps_under_a_span_with_a_device_side_copy(host_end, late):
    """``Trace.idle_gaps`` sweeps the host events with the spans' device
    copies among them.  A copy inside its host span (a span that ends on
    a read) names the gap the span held.  A copy that runs past its
    host span's end (a span that ends on no read) still names a gap
    after that end, where the host was in ``portbench.answer``: the
    breakdown depends on the copies until ``Trace`` drops them
    (PERF.md §7).  Without the copy that gap falls to
    ``portbench.answer``."""
    dev = [Interval("greedy_pick_batch", 0.0, 2.0),
           Interval("bitwise_or", 2.0, 2.2),
           Interval("bitwise_or", 3.3, 3.5),
           Interval("greedy_pick_batch", 3.5, 10.0)]
    span = Interval("repro_torch.service.finalize", 1.0, host_end)
    copy = Interval("repro_torch.service.finalize", 2.0, 3.5)
    tr = Trace(dev, [Interval("portbench.window", 0.0, 10.0),
                     Interval("portbench.answer", 0.5, 9.0)],
               [span, copy, Interval("aten::select", 3.2, 3.4)])
    assert spans.program(tr, "service.finalize") == [span]
    assert tr.idle_gaps() == [[late, pytest.approx(1.1)]]
    tr.host = [span, Interval("aten::select", 3.2, 3.4)]
    alone = late if host_end > 3.5 else "portbench.answer"
    assert tr.idle_gaps() == [[alone, pytest.approx(1.1)]]
