"""The plain reference against the port, on the CPU at small sizes:
every draw, RRR set, selection, IMM round and answer equal."""
import math

import pytest
import torch

from portbench import check, lookup
from portbench.conftest import small_graph
from portbench.reference import cover, sampler, threefry
from repro_torch.core import imm, prng, rrr, service
from repro_torch.graphs.csr import (from_arrays, padded_adjacency,
                                    padded_forward_adjacency)

# (scale, edgefactor, seed): Graph500 Kronecker graphs whose in-degrees
# reach past 32 (several coin chunks, the LT sums in blocks) and, on the
# larger, past 256 (the sums' blocks in blocks)
GRAPHS = {"sparse": (8, 4, 5), "dense": (10, 16, 9)}
KEY = (7, 2**31 + 3)


def _both(shape):
    a = small_graph(*GRAPHS[shape])
    return (a, from_arrays(a.indptr, a.indices, a.probs, a.weights,
                           device="cpu"),
            sampler.Graph(a.indptr, a.indices, a.probs, a.weights,
                          device="cpu"))


def _port_rows(g, model, theta=96):
    nbr, prob, wt = padded_adjacency(g)
    return rrr.sample_incidence(
        nbr, prob, wt, prng.Key(*KEY), theta=theta, n=g.num_vertices,
        model=model, sampler="kernel", fwd=padded_forward_adjacency(g),
        max_steps=32)


def _same(a: cover.Entries, b: cover.Entries) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))


def test_threefry_draws_equal_the_port():
    k, p = threefry.Key(*KEY), prng.Key(*KEY)
    assert (k.fold_in(5).k0, k.fold_in(5).k1) == (p.fold_in(5).k0,
                                                  p.fold_in(5).k1)
    assert [(s.k0, s.k1) for s in k.split()] == [(s.k0, s.k1)
                                                 for s in p.split()]
    idx = torch.arange(1000)
    assert torch.equal(k.uniform_at(idx), p.uniform_at(idx))
    assert torch.equal(k.randint_at(idx, 317),
                       p.randint((1000,), 0, 317, device="cpu").long())
    assert torch.equal(k.permutation(515, device="cpu"),
                       p.permutation(515, device="cpu").long())
    assert threefry.Key.from_seed(2**31 + 9) == threefry.Key(0, 2**31 + 9)
    assert threefry.Key.from_seed(2**40 + 1) == threefry.Key(256, 1)


@pytest.mark.parametrize("model", ["IC", "LT"])
@pytest.mark.parametrize("shape", sorted(GRAPHS))
def test_rrr_sets_equal_the_port(model, shape):
    _, g, rg = _both(shape)
    rows = _port_rows(g, model)
    b, v = sampler.draw(rg, threefry.Key(*KEY), torch.arange(96),
                        model=model, max_steps=32, block=13)
    assert _same(check.entries_of(rows), cover.from_pairs(b, v, rg.n, 96))


@pytest.mark.parametrize("model", ["IC", "LT"])
@pytest.mark.parametrize("shape", sorted(GRAPHS))
def test_randgreedi_equals_the_port(model, shape):
    _, g, _ = _both(shape)
    rows = _port_rows(g, model)
    sel = imm.make_randgreedi_selector(4, "streaming", 0.077,
                                       use_kernel=True, solver="resident")
    seeds, cov = sel(rows, 10, prng.Key(3, 4))
    ref_seeds, ref_cov = cover.randgreedi(
        check.entries_of(rows), threefry.Key(3, 4), m=4, k=10, delta=0.077)
    assert seeds.tolist() == ref_seeds.tolist() and int(cov) == ref_cov


@pytest.mark.parametrize("check_per_word", [0, 3])
@pytest.mark.parametrize("model", ["IC", "LT"])
def test_imm_rounds_equal_the_port(model, check_per_word):
    a, g, rg = _both("sparse")
    cfg = dict(model=model, k=5, eps=0.5, delta=0.077, machines=4,
               max_theta=2048, max_steps=32, check_per_word=check_per_word)
    seed = 2**31 + 41
    sel = imm.make_randgreedi_selector(4, "streaming", 0.077,
                                       use_kernel=True, solver="resident")
    seen = {}

    def wrapped(rows, k, key):
        seen["rows"] = rows
        out = sel(rows, k, key)
        seen.setdefault("calls", []).append(
            (rows.shape[1], (key.k0, key.k1), tuple(out[0].tolist()),
             int(out[1])))
        return out
    res = imm.imm(g, 5, 0.5, prng.Key(0, seed).fold_in(2), model=model,
                  selector=wrapped, max_theta=2048, sampler="kernel")
    result = (tuple(int(s) for s in res.seeds), res.coverage_fraction,
              res.theta, res.rounds, res.lb)
    got = check.imm_numbers(rg, cfg, seed, 2, check.entries_of(seen["rows"]),
                            seen["calls"], result)
    assert got == {"sampler_off": 0, "selection_off": 0}
    # a seed changed anywhere is seen
    bad = list(result)
    bad[0] = (bad[0][0] + 1,) + bad[0][1:]
    assert check.imm_numbers(rg, cfg, seed, 2,
                             check.entries_of(seen["rows"]), seen["calls"],
                             tuple(bad))["selection_off"] == 1


def test_answers_equal_the_port():
    a, g, rg = _both("sparse")
    cfg = dict(model="IC", max_steps=32, pool_theta=256, slab=64,
               fail_prob=1 / 128)
    seed = 2**31 + 5
    svc = service.InfluenceService(
        g, prng.Key(0, seed), theta0=256, max_theta=256, slab=64,
        solver="resident", model="IC", sampler="kernel", max_steps=32,
        delta=1 / 128)
    queries = [service.Query(k=k, excluded=ex, budget=b, eps=0.3)
               for k, ex, b in [(5, (), None), (8, (1, 2, 3), None),
                                (3, (7,), 2.5), (1, (), None),
                                (7, (0, 255), 40.0)]]
    answers = svc.answer([svc.admit(q) for q in queries])
    halves = check.pool_entries(rg, cfg, seed, 1)
    assert check.pool_off(halves, [check.entries_of(svc.pool.r1),
                                   check.entries_of(svc.pool.r2)]) == 0
    ref = check.reference_answers(halves, queries, cfg, group=2)
    assert [tuple(r) for r in ref] == [check.answer_fields(x)
                                       for x in answers]
    assert all(math.isfinite(r.sigma_upper) for r in ref)


def test_the_checked_samples_cover_every_word():
    cfg = dict(check_per_word=3)
    cols = check.check_columns(cfg, 2**33 + 1, 4, 1000, "cpu")
    words = torch.bincount(cols // 32)
    assert words.numel() == 32 and int(words[:-1].min()) == 3
    assert torch.equal(cols, torch.unique(cols)) and int(cols.max()) < 1000
    assert not torch.equal(cols, check.check_columns(cfg, 2**33 + 2, 4,
                                                     1000, "cpu"))
    assert torch.equal(check.check_columns(dict(check_per_word=32), 1, 0,
                                           70, "cpu"), torch.arange(70))


def test_the_kronecker_graph_is_simple_undirected_and_skewed():
    a = small_graph(10, 16, 3)
    head = torch.repeat_interleave(torch.arange(a.n),
                                   torch.from_numpy(a.indptr).diff())
    src = torch.from_numpy(a.indices)
    code = head * a.n + src
    assert not bool((head == src).any())
    assert torch.unique(code).numel() == code.numel()
    assert torch.equal(torch.sort(code).values,
                       torch.sort(src * a.n + head).values)
    deg = torch.from_numpy(a.indptr).diff()
    assert int(deg.max()) > 20 * float(deg.float().mean())
    again = small_graph(10, 16, 3)
    assert all((x == y).all() for x, y in zip(a, again))
    assert lookup.module("graphs", "kronecker").edges


def test_the_lt_choice_by_search_equals_the_choice_by_count(monkeypatch):
    _, _, rg = _both("dense")
    want = sampler.draw(rg, threefry.Key(*KEY), torch.arange(96),
                        model="LT", max_steps=32)
    monkeypatch.setattr(rg, "rising", lambda: torch.zeros(rg.n,
                                                          dtype=torch.bool))
    got = sampler.draw(rg, threefry.Key(*KEY), torch.arange(96),
                       model="LT", max_steps=32)
    assert all(torch.equal(x, y) for x, y in zip(want, got))
