"""The CSR reference (``reference/csr_sampler.py``, ``check_csr.py``)
and the ``g500_lt_s18.imm`` cell on the CPU at small sizes: the CSR
reference draws ``reference/sampler.py``'s walks, walk for walk, and
takes its slot at every padded sum; the cell runs end to end, and a
walk altered, a sample left out, a seed altered or the bfloat16 control
turn ``correct`` false; ``rrr.lt_roofline``'s count matches a hand
count."""
import time
import types

import pytest
import torch

from portbench import control, harness, lt_counts
from portbench.conftest import small_graph
from portbench.reference import csr_sampler, sampler, threefry
from portbench.trace import Interval, Trace
from repro_torch.core import bitset, prng, rrr
from repro_torch.graphs import csr
from repro_torch.kernels import rrr_expand

# (scale, edgefactor, seed): the second has rows past 256 in-arcs,
# whose padded tails hold other levels' sums
GRAPHS = {"sparse": (8, 4, 5), "dense": (10, 16, 9)}
CELL = "g500_lt_s18.imm"
SEED = 2**31 + 77


def _graphs(shape):
    a = small_graph(*GRAPHS[shape])
    args = (a.indptr, a.indices, a.probs, a.weights)
    return (csr_sampler.Graph(*args, device="cpu"),
            sampler.Graph(*args, device="cpu"), a)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(GRAPHS))
def test_csr_walks_equal_the_padded_reference(shape, precision):
    cg, pg, _ = _graphs(shape)
    key = threefry.Key(7, 2**31 + 3)
    cols = torch.arange(400)
    got = csr_sampler.draw(cg, key, cols, model="LT", max_steps=32,
                           precision=precision, block=97)
    want = sampler.draw(pg, key, cols, model="LT", max_steps=32,
                        precision=precision, block=97)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert got[0].numel() > 2 * cols.numel()      # walks past their roots


class _Draws:
    """A step key whose uniforms are the given values, in order."""

    def __init__(self, r):
        self.r = r

    def uniform_at(self, idx):
        return self.r


def test_each_choice_is_the_padded_rows_count():
    """At every distinct padded sum of every row, and an ulp either
    side, the CSR reference follows the padded reference's in-edge."""
    a = small_graph(11, 16, 9)      # rows to 794 in-arcs, two that dip
    args = (a.indptr, a.indices, a.probs, a.weights)
    cg = csr_sampler.Graph(*args, device="cpu")
    pg = sampler.Graph(*args, device="cpu")
    cw = pg.cumw()
    v, r = [], []
    for row in range(pg.n):
        if int(pg.deg[row]) > 200 or row % 16 == 0:
            vals = torch.unique(cw[row])
            for x in (vals, torch.nextafter(vals, torch.tensor(0.0)),
                      torch.nextafter(vals, torch.tensor(2.0))):
                v.append(torch.full(x.shape, row))
                r.append(x)
    v, r = torch.cat(v), torch.cat(r)
    b = torch.zeros_like(v)
    dips = sum(
        bool((cw[i, int(pg.deg[i]):] < cw[i, :int(pg.deg[i])].max()).any())
        for i in range(pg.n) if 0 < int(pg.deg[i]) < pg.d)
    assert dips > 0                                 # tails below a row's sum
    assert cg.lt_tables()[4].ge(0).sum() == dips
    for precision in ("float32", "bfloat16"):
        got = csr_sampler._lt_hits(cg, _Draws(r), b, v, precision)
        want = sampler._lt_hits(pg, _Draws(r), b, v, precision)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_the_csr_reference_holds_no_padded_table():
    cg, _, _ = _graphs("sparse")
    with pytest.raises(RuntimeError, match="no padded table"):
        cg.cumw()


def _cell(**config) -> harness.Cell:
    cell = harness.Cell(CELL, harness.load_json(harness.ROOT /
                                                "BENCHMARK.json"))
    cell.config.update(dict(scale=8, edgefactor=4, max_theta=1024, k=6),
                       **config)
    return cell


def _run(cell, traced=False):
    return harness.run(cell, SEED, 0.2, traced, "cpu", time.perf_counter())


@pytest.mark.parametrize("traced", [False, True])
def test_the_cell_runs_end_to_end_on_the_cpu(traced):
    cell = _cell()
    assert cell.traffic["entry"] == "imm_csr"
    out = _run(cell, traced)
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    assert all(v["value"] == 0 for v in out["checked"].values())
    names = {m["name"] for m in (cell.per_layer if traced
                                 else cell.end_to_end)}
    assert names >= {"imm.tables_s.s18", "rrr.lt_roofline"} if traced \
        else names == {"selection_s.lt", "peak_device_gib", "setup_s"}
    if not traced:
        assert set(out["metrics"]) == names


def _walk_altered(monkeypatch):
    """Every step puts two isolated vertices (no in-arc: no walk reaches
    one, and at most one is sample 0's root) in sample 0's set."""
    push = rrr._PUSH["LT"]

    def altered(t, sub, words, frontier, visited, *rest):
        push(t, sub, words, frontier, visited, *rest)
        alone = torch.nonzero(t.lt.indptr[1:] == t.lt.indptr[:-1])[:2, 0]
        visited[alone, 0] |= 1
    monkeypatch.setitem(rrr._PUSH, "LT", altered)


def _sample_left_out(monkeypatch):
    """The roots of one sample per sampling call left out."""
    from repro_torch.core import imm as port_imm
    draw = port_imm.sample_incidence

    def left_out(*a, **kw):
        out = draw(*a, **kw)
        out[:, 0] &= ~1
        return out
    monkeypatch.setattr(port_imm, "sample_incidence", left_out)


def _seed_altered(monkeypatch):
    from repro_torch.core import randgreedi
    solve = randgreedi.randgreedi_maxcover

    def altered(rows, *a, **kw):
        res = solve(rows, *a, **kw)
        seeds = res.seeds.clone()
        seeds[0] = (seeds[0] + 1) % rows.shape[0]
        return res._replace(seeds=seeds)
    monkeypatch.setattr(randgreedi, "randgreedi_maxcover", altered)


@pytest.mark.parametrize("fault", [_walk_altered, _sample_left_out,
                                   _seed_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _run(_cell())
    assert not out["correct"]
    assert any(v["value"] > v["limit"] for v in out["checked"].values())


def test_the_control_is_not_correct():
    program, ctrl = control.readings(_cell(), SEED, "cpu", seconds=0.1)
    assert all(v == 0 for v in program.values())
    assert any(ctrl[k] > 0 for k in program), ctrl


def test_lt_roofline_counts_by_hand():
    """The push's counters on a small graph, against the steps counted
    by hand through the dense entry point, and the bytes they give."""
    a = small_graph(*GRAPHS["dense"])
    g = csr.from_arrays(a.indptr, a.indices, a.probs, a.weights,
                        device="cpu")
    lt = csr.lt_reverse(g)
    roots = prng.Key(1, 2).randint((64,), 0, g.num_vertices, device="cpu")
    stats = {}
    rrr.rrr_batch_packed(None, None, None, None, None, roots, prng.Key(3, 4),
                         model="LT", max_steps=32, expand="kernel",
                         stats=stats, lt=lt)
    deg = (lt.indptr[1:] - lt.indptr[:-1]).tolist()
    visited = frontier = rrr.packed_roots(roots, g.num_vertices)
    key, words, bits, reads = prng.Key(3, 4), 0, 0, 0
    for _ in range(stats["bfs_steps"]):
        words += int((frontier != 0).sum())
        per_v = bitset.popcount(frontier).sum(1).tolist()
        bits += sum(per_v)
        reads += sum(min(c * ((d - 1).bit_length() + 1), d)
                     for c, d in zip(per_v, deg) if d)
        key, sub = key.split()
        frontier, visited = rrr_expand.rrr_expand_step_lt(
            frontier, visited, lt.indptr, lt.src, lt.cumw, sub)
    assert (stats["frontier_words"], stats["frontier_bits"],
            stats["choice_reads"], stats["root_bits"]) == (words, bits,
                                                            reads, 64)
    want = 16 * words + 4 * reads + 4 * (bits - 64) + 20 * (words - 64)
    assert lt_counts.push_bytes(words, bits, 64, reads) == want
    assert lt_counts.bound_s(stats) == pytest.approx(want / 3.35e12)
    assert lt_counts.bound_s({"frontier_words": 1}) is None


def test_lt_roofline_reads_the_push_in_the_steps():
    dev = [Interval("push_lt_kernel", 1.0, 1.5),
           Interval("push_lt_kernel", 2.0, 2.5),
           Interval("aten::add", 2.6, 2.9),            # in a step, not push
           Interval("push_lt_kernel", 6.0, 9.0)]       # outside the steps
    host = [Interval("repro_torch.rrr.step", 0.5, 1.8),
            Interval("repro_torch.rrr.step", 1.9, 3.0)]
    tr = Trace(dev, [Interval("portbench.window", 0.0, 10.0)], host)
    stats = dict(frontier_words=100, frontier_bits=90, root_bits=40,
                 choice_reads=300)
    run = types.SimpleNamespace(trace=tr, stats=stats, units=1, counts={},
                                cell="c")
    bound = lt_counts.push_bytes(100, 90, 40, 300) / 3.35e12
    assert harness.reader("rrr.lt_roofline")(run) == pytest.approx(
        100.0 * bound / 1.0)
    run.stats = {}
    assert harness.reader("rrr.lt_roofline")(run) is None
    assert harness.reader("imm.tables_s.s18")(run) is None   # no tables span
