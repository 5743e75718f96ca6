"""The counting arithmetic and the trace reader on small inputs, where
the counts are exact."""
import types

import pytest
import torch

from portbench import counts, harness, lookup
from portbench.conftest import small_graph
from portbench.reference import sampler, threefry
from portbench.trace import Interval, Trace
from repro_torch.core import prng, rrr
from repro_torch.graphs.csr import (from_arrays, padded_adjacency,
                                    padded_forward_adjacency)


def test_coins_count_every_coin_the_draw_makes(monkeypatch):
    a = small_graph(8, 8, 3)
    a.probs[::7] = 0.0              # arcs that need no coin
    g = from_arrays(a.indptr, a.indices, a.probs, a.weights, device="cpu")
    nbr, prob, wt = padded_adjacency(g)
    rows = rrr.sample_incidence(
        nbr, prob, wt, prng.Key(1, 2), theta=64, n=a.n, model="IC",
        sampler="kernel", fwd=padded_forward_adjacency(g), max_steps=32)
    rg = sampler.Graph(a.indptr, a.indices, a.probs, a.weights,
                       device="cpu")
    drawn = []
    hits = sampler._ic_hits

    def counting(g_, sub, b, v, precision):
        drawn.append(int((g_.prob[torch.repeat_interleave(
            g_.indptr[v], g_.deg[v]) + _within(g_.deg[v])] > 0).sum()))
        return hits(g_, sub, b, v, precision)
    monkeypatch.setattr(sampler, "_ic_hits", counting)
    sampler.draw(rg, threefry.Key(1, 2), torch.arange(64), model="IC",
                 max_steps=32)
    slots = torch.from_numpy(counts.live_slots(a.indptr, a.probs))
    assert counts.coins(rows, slots, block=37) == sum(drawn) > 0


def _within(deg):
    first = torch.cumsum(deg, 0) - deg
    return torch.arange(int(deg.sum())) - torch.repeat_interleave(first, deg)


def test_byte_counts():
    assert counts.select_bytes(8, 3, 100) == 4 * (24 + 101)
    # pool [10, 4] read once; per query 2 exclusions, cover 4, seeds and
    # gains 2 x 5, selected rows 5 x 4
    assert counts.query_batch_bytes(10, 4, 3, 5, 2) == 4 * (40 + 3 * 36)
    assert counts.bound_s(3.35e12) == pytest.approx(1.0)
    assert counts.sampler_bound_s(0, 3.35e12) == pytest.approx(1.0)
    coins = counts.INT32_OPS_PER_S / counts.OPS_PER_COIN
    assert counts.sampler_bound_s(2 * coins, 1) == pytest.approx(2.0)


def _trace():
    dev = [Interval("push_ic_kernel", 1.0, 3.0),
           Interval("copy", 2.0, 4.0),
           Interval("greedy_pick_compact_kernel", 6.0, 7.0),
           Interval("outside", 20.0, 21.0)]
    spans = [Interval("portbench.window", 0.0, 10.0),
             Interval("portbench.selection", 0.5, 8.0),
             Interval("portbench.selector", 5.5, 7.5)]
    host = [Interval("aten::cat", 4.0, 5.0), Interval("numpy", 8.5, 9.5)]
    return Trace(dev, spans, host)


def test_busy_is_the_union_of_device_intervals_not_their_sum():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(4.0)       # [1, 4] and [6, 7]
    assert tr.device_s() == pytest.approx(5.0)     # summed, in the window
    sel = tr.named("portbench.selection")
    assert tr.device_s(within=sel, without=tr.named(
        "portbench.selector")) == pytest.approx(4.0)
    assert tr.device_s(names=["greedy_pick"]) == pytest.approx(1.0)
    # idle [0, 1], [4, 6], [7, 10], each by the innermost host operation
    # under its middle
    assert tr.idle_gaps() == [["numpy", pytest.approx(3.0)],
                              ["aten::cat", pytest.approx(2.0)],
                              ["portbench.selection", pytest.approx(1.0)]]
    assert tr.device_ops()[0] == ["push_ic_kernel", 2.0]


def test_a_missing_kernel_fails_the_traced_run():
    tr = _trace()
    harness.require_kernels(tr, ["push_ic_kernel", "greedy_pick_compact"])
    with pytest.raises(RuntimeError, match="push_lt_kernel"):
        harness.require_kernels(tr, ["push_lt_kernel"])


def _run(tr, **counts_):
    return types.SimpleNamespace(trace=tr, stats={"sample_s": 2.0,
                                                  "select_s": 1.0,
                                                  "solve_s": 3.0,
                                                  "solves": 6},
                                 units=2, counts=counts_, cell="c")


METRICS = sorted(p.stem for p in (harness.HERE / "metrics").glob("*.py"))


@pytest.mark.parametrize("metric", METRICS)
def test_a_reader_without_a_trace_reads_nothing_of_the_device(metric):
    got = harness.reader(metric)(_run(None))
    if metric.startswith(("imm.sample_s", "imm.select_s", "serve.solve_s")):
        assert got > 0
    else:
        assert got is None


def test_readers_on_a_trace():
    tr = _trace()
    run = _run(tr, sampler_bound_s_last=1.0, select_bound_s=0.5,
               query_bound_s=0.25)
    read = {m: harness.reader(m)(run) for m in METRICS}
    assert read["sampler.device_ms"] == pytest.approx(2000.0)
    assert read["sampler_roofline"] == pytest.approx(25.0)
    assert read["select.device_ms"] == pytest.approx(500.0)
    assert read["select_roofline"] == pytest.approx(50.0)
    assert read["device.idle_pct"] == pytest.approx(60.0)
    assert read["imm.sample_s"] == pytest.approx(1.0)
    assert read["serve.solve_s"] == pytest.approx(0.5)
    assert read["query_solve.device_ms"] is None    # no such kernel


def test_a_variant_reads_with_its_quantitys_reader():
    assert lookup.reader_name("device.idle_pct.select.lt") == \
        "device.idle_pct"
    assert lookup.reader_name("select_roofline.lt") == "select_roofline"
    assert lookup.reader_name("imm.sample_s") == "imm.sample_s"
    with pytest.raises(FileNotFoundError):
        lookup.reader_name("no_such_metric")
