"""The port's spans and counters: the spans nest as the layers do under
``torch.profiler``, no span is entered while no profiler records, the
counters count what the sampler and the IMM loop did, ``stats=None``
changes nothing, and ``StageClock`` still adds its seconds."""
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch import core  # noqa: E402
from repro_torch.core import bitset, imm, prng, rrr, service  # noqa: E402
from repro_torch.graphs import csr, generators  # noqa: E402

KEY = prng.Key(3, 2**31 + 5)


def _graph(n_log2=7, nnz=700):
    """A small Kronecker (R-MAT) graph with skewed degrees."""
    return generators.rmat(n_log2, nnz, seed=4, device="cpu")


def _spans(prof) -> list[tuple[str, int, int]]:
    """(name, start, end) in ns of the program's spans the profiler
    recorded on the host."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(core.SPAN_PREFIX) and \
                "CPU" in str(e.device_type()):
            out.append((e.name()[len(core.SPAN_PREFIX):], e.start_ns(),
                        e.start_ns() + e.duration_ns()))
    return out


def _inside(spans, child: str, parents: tuple[str, ...]) -> bool:
    """Every ``child`` span lies inside a span named in ``parents``."""
    outer = [s for s in spans if s[0] in parents]
    kids = [s for s in spans if s[0] == child]
    return bool(kids) and all(
        any(p[1] <= c[1] and c[2] <= p[2] for p in outer) for c in kids)


def _imm(model="IC", stats=None, gather="auto"):
    return imm.imm(_graph(), 3, 0.5, KEY, model=model, max_theta=512,
                   selector=imm.make_randgreedi_selector(4), gather=gather,
                   stats=stats)


def _imm_streamed():
    return _imm(gather="streamed")


def _imm_lt():
    return _imm(model="LT")


def _serve(stats=None):
    svc = service.InfluenceService(_graph(), KEY, theta0=128,
                                   max_theta=256, slab=64, stats=stats)
    queries = [service.Query(k=3), service.Query(k=2, excluded=(1, 5)),
               service.Query(k=4, budget=3.0)]
    return svc.answer([svc.admit(q) for q in queries])


NESTING = {
    "imm": (_imm, [("rrr.step", ("rrr.sample",)),
                   ("rrr.tables", ("rrr.sample",)),
                   ("rrr.sample", ("imm.sample",)),
                   ("imm.sample", ("imm.round", "imm.final")),
                   ("imm.select", ("imm.round", "imm.final")),
                   ("randgreedi.partition", ("imm.select",)),
                   ("randgreedi.local", ("imm.select",)),
                   ("randgreedi.receiver", ("imm.select",)),
                   ("randgreedi.merge", ("imm.select",))]),
    "serve": (_serve, [("service.query_arrays", ("serve.solve",)),
                       ("service.solve", ("serve.solve",)),
                       ("service.finalize", ("serve.solve",)),
                       ("service.read", ("serve.solve",)),
                       ("service.certify", ("serve.solve",)),
                       ("rrr.step", ("rrr.sample",))]),
    # the streamed layout gathers through the forward table, which the
    # push (the default's) never builds
    "imm_streamed": (_imm_streamed,
                     [("tables.forward.copy", ("tables.forward",)),
                      ("rrr.tables", ("rrr.sample",)),
                      ("rrr.step", ("rrr.sample",))]),
    # the LT push reads the CSR tables (tables.lt), no padded table
    "imm_lt": (_imm_lt, [("rrr.step", ("rrr.sample",)),
                         ("rrr.tables", ("rrr.sample",)),
                         ("rrr.sample", ("imm.sample",))]),
}


@pytest.mark.parametrize("case", sorted(NESTING))
def test_the_spans_nest_as_the_layers_do(case):
    run, pairs = NESTING[case]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    spans = _spans(prof)
    for child, parents in pairs:
        assert _inside(spans, child, parents), (child, parents)
    names = {s[0] for s in spans}
    if case.startswith("imm"):
        table = "tables.lt" if case == "imm_lt" else "tables.reverse"
        assert names >= {"imm.round", "imm.final", table}
        assert ("tables.forward" in names) == (case == "imm_streamed")
        assert ("tables.reverse" in names) == (case != "imm_lt")
    else:
        assert "tables.forward" not in names
        phases = ["service.query_arrays", "service.solve",
                  "service.finalize", "service.read", "service.certify"]
        firsts = [min(s[1] for s in spans if s[0] == p) for p in phases]
        assert firsts == sorted(firsts)     # a batch's phases, in order


def _refuse(*a, **kw):
    raise AssertionError("a span was entered with no profiler recording")


@pytest.mark.parametrize("run", [_imm, _serve], ids=["imm", "serve"])
def test_no_span_is_entered_without_a_profiler(monkeypatch, run):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    run(stats={})
    run()


def _live_words_per_step(t, roots, key, max_steps, model):
    """The plain path's BFS, counting each step's non-zero frontier
    words: what the push's lists must hold."""
    visited = rrr.packed_roots(roots, t.n)
    frontier, step, words = visited, 0, 0
    while step < max_steps and bool(frontier.any()):
        words += int(torch.count_nonzero(frontier))
        key, sub = key.split()
        frontier, visited = rrr._step(t, sub, frontier, visited, model)
        step += 1
    return step, words


@pytest.mark.parametrize("model", ["IC", "LT"])
def test_frontier_words_count_the_live_words_of_every_step(model):
    g = _graph(6, 300)
    nbr, prob, wt = csr.padded_adjacency(g)
    fwd = csr.padded_forward_adjacency(g)
    roots = prng.Key(9, 9).randint((64,), 0, g.num_vertices, device="cpu")
    stats = {}
    got = rrr.rrr_batch_packed(nbr, prob, wt, *fwd, roots, KEY, model=model,
                               max_steps=32, expand="kernel", stats=stats)
    t = rrr._Tables(nbr, prob, wt, *fwd, model=model, coin_chunk=32)
    steps, words = _live_words_per_step(t, roots, KEY, 32, model)
    assert (stats["bfs_steps"], stats["frontier_words"]) == (steps, words)
    assert words > bitset.num_words(64)         # the walks went past roots
    plain = rrr.rrr_batch_packed(nbr, prob, wt, *fwd, roots, KEY,
                                 model=model, max_steps=32, expand="plain")
    assert torch.equal(got, plain)


@pytest.mark.parametrize("model", ["IC", "LT"])
def test_the_imm_counters(model):
    """``imm`` fills exactly the keys its docstring lists; every BFS
    step pushes at least one live word."""
    stats = {}
    _imm(model, stats)
    lt = {"frontier_bits", "root_bits", "choice_reads"} if model == "LT" \
        else set()
    assert set(stats) == {"sample_s", "select_s", "bfs_steps",
                          "frontier_words"} | lt
    assert stats["frontier_words"] >= stats["bfs_steps"] > 0
    if lt:
        assert stats["frontier_bits"] > stats["root_bits"] > 0
        assert stats["choice_reads"] > 0


@pytest.mark.parametrize("run", [_imm, _serve], ids=["imm", "serve"])
def test_no_stats_writes_nothing_and_changes_nothing(run):
    stats = {}
    with_stats = run(stats=stats)
    assert stats
    without = run()
    if run is _imm:
        assert (with_stats.seeds.tolist(), with_stats.theta) == \
            (without.seeds.tolist(), without.theta)
    else:
        assert [a.seeds.tolist() for a in with_stats] == \
            [a.seeds.tolist() for a in without]


@pytest.mark.parametrize("layer", [None, "t"])
def test_the_stage_clock_adds_its_seconds(layer):
    stats = {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with core.StageClock(stats, "wait_s", "cpu", layer=layer):
                time.sleep(0.01)
        with core.StageClock(None, "none_s", "cpu", layer=layer):
            pass
    assert set(stats) == {"wait_s"} and stats["wait_s"] >= 0.02
    names = [s[0] for s in _spans(prof)]
    assert names == ([] if layer is None else ["t.wait"] * 2 + ["t.none"])


def test_a_span_outside_a_profiler_is_one_shared_no_op():
    assert core.span("a") is core.span("b")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with core.span("a"):
            pass
    assert [s[0] for s in _spans(prof)] == ["a"]
