"""Port parity: the online influence service (``core.service``) against
the reference's — the same pool words for every sampler and model, the
same answers (seeds, coverages, sigma bounds, ``certified``,
``degraded``) for every solver, the same snapshot leaves, and the
reference's lifecycle behaviour (drain, eviction, deadlines, retry)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import service as ref  # noqa: E402
from repro.graphs.csr import from_edge_list  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.core import maxcover, prng  # noqa: E402
from repro_torch.core import service as svc  # noqa: E402
from repro_torch.core.service import (EmptyPoolError,  # noqa: E402
                                      InfluenceService, Query,
                                      StaleGenerationError)
from repro_torch.runtime.faults import (FaultPlan, FaultSpec,  # noqa: E402
                                        InjectedFault)
from tests.test_torch_ref import (partitionable, port_graph, port_key,  # noqa: E402,F401
                                  u32)


def _graph(n=37, m=150, seed=0, p=0.3, extra=None):
    """The reference test's graph: n = 37 (not word-aligned), explicit
    probabilities; ``extra`` (src, dst) edges are appended."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if extra is not None:
        src = np.concatenate([src, extra[0]])
        dst = np.concatenate([dst, extra[1]])
    return from_edge_list(src, dst, n, probs=np.full(src.shape[0], p))


@pytest.fixture(scope="module")
def graphs():
    g = _graph()
    return g, port_graph(g)


TRACE = [
    (3, (), None),
    (5, (0, 4, 9), None),
    (2, (1,), None),
    (4, (), 6.0),
    (1, (), None),
    (5, (2, 3, 5, 7, 11), None),
    (3, (6,), 3.5),
    (4, (), None),
]


def _queries(mod):
    return [mod.Query(k=k, excluded=e, budget=b) for k, e, b in TRACE]


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a.seeds), np.asarray(b.seeds))
        assert tuple(a[1:]) == tuple(b[1:])


def _same_pool(p, r):
    np.testing.assert_array_equal(u32(p.r1), u32(r.r1))
    np.testing.assert_array_equal(u32(p.r2), u32(r.r2))
    np.testing.assert_array_equal(p.salt, r.salt)
    assert (p.theta, p.generation) == (r.theta, r.generation)


@pytest.mark.parametrize("model", ["IC", "LT"])
@pytest.mark.parametrize("sampler", ["dense", "packed", "kernel"])
def test_make_pool_and_refresh_match_reference(graphs, model, sampler):
    g, pg = graphs
    key = jax.random.PRNGKey(42)
    want = ref.make_pool(g, key, theta=100, slab=64, model=model,
                         sampler=sampler)
    got = svc.make_pool(pg, port_key(key), theta=100, slab=64, model=model,
                        sampler=sampler)
    assert got.theta == 128 and got.words == 4
    _same_pool(got, want)
    want2, got2 = ref.refresh(want, 256), svc.refresh(got, 256)
    _same_pool(got2, want2)
    # growth keeps the old columns bit for bit, and the old pool is intact
    np.testing.assert_array_equal(u32(got2.r1)[:, :4], u32(got.r1))
    assert list(got2.salt) == [0, 0, 1, 1]


def test_refresh_must_grow(graphs):
    pool = svc.make_pool(graphs[1], prng.key(1), theta=128, slab=128)
    with pytest.raises(ValueError, match="must grow"):
        svc.refresh(pool, 128)
    with pytest.raises(ValueError, match="multiple of 32"):
        svc.make_pool(graphs[1], prng.key(1), theta=128, slab=48)


def test_refresh_mutated_resamples_the_same_slabs():
    """Edge insertion: the slabs whose samples contain the new edge's
    head are the reference's, resampled into the same words; the other
    columns carry over."""
    g = _graph(p=0.1)
    key = jax.random.PRNGKey(5)
    want = ref.make_pool(g, key, theta=256, slab=32, sampler="packed")
    got = svc.make_pool(port_graph(g), port_key(key), theta=256, slab=32,
                        sampler="packed")
    hits = (u32(got.r1) | u32(got.r2)) != 0
    v = int(np.argmin(np.where(hits.any(1), hits.sum(1), 99)))
    g_new = _graph(p=0.1, extra=(np.array([20]), np.array([v])))
    stale = ref.affected_slabs(want, [v])
    np.testing.assert_array_equal(svc.affected_slabs(got, [v]), stale)
    assert 0 < stale.size < 8
    want2 = ref.refresh_mutated(want, g_new, [v])
    got2 = svc.refresh_mutated(got, port_graph(g_new), [v])
    _same_pool(got2, want2)
    for s in range(8):       # untouched slabs carry over column for column
        if s not in stale:
            np.testing.assert_array_equal(u32(got2.r1)[:, s:s + 1],
                                          u32(got.r1)[:, s:s + 1])
    # no touched sample: only the generation moves
    none = svc.refresh_mutated(got2, got2.g, [])
    assert none.generation == got2.generation + 1
    assert none.r1 is got2.r1


@pytest.fixture(scope="module")
def pools(graphs):
    g, pg = graphs
    key = jax.random.PRNGKey(42)
    want = ref.refresh(ref.make_pool(g, key, theta=128, slab=128), 256)
    got = svc.refresh(svc.make_pool(pg, port_key(key), theta=128, slab=128,
                                    sampler="dense"), 256)
    return got, want


@pytest.mark.parametrize("solver", maxcover.SOLVERS)
def test_answer_batch_matches_reference(pools, solver):
    """B = 8 queries with mixed k, exclusions and budgets in one batched
    solve: the reference's answers, field for field, and the port's own
    sequential ``answer_one``."""
    got_pool, want_pool = pools
    got = svc.answer_batch(got_pool, _queries(svc), solver=solver)
    _same(got, ref.answer_batch(want_pool, _queries(ref), solver=solver))
    _same(got, [svc.answer_one(got_pool, q, solver=solver)
                for q in _queries(svc)])
    assert any(a.k_used < q.k for a, q in zip(got, _queries(svc)))


def test_estimate_spread_matches_reference(pools):
    got_pool, want_pool = pools
    seeds = [3, -1, 7, 30]
    assert svc.estimate_spread(got_pool, seeds) == \
        ref.estimate_spread(want_pool, np.asarray(seeds))


def test_pool_state_and_snapshot_round_trip(pools, tmp_path):
    """``pool_state``'s leaves equal the reference's (key words, both
    halves, salts, scalars with the reference's model and sampler
    codes); a snapshot through the store restores the pool bit for bit,
    and a refresh after the restore appends the same slabs."""
    got_pool, want_pool = pools
    want = ref.pool_state(want_pool)
    got = svc.pool_state(got_pool)
    assert sorted(got) == sorted(want)
    for name in got:
        np.testing.assert_array_equal(u32(got[name]).astype(np.int64),
                                      u32(want[name]).astype(np.int64))
    store = CheckpointStore(str(tmp_path))
    assert svc.snapshot_pool(store, got_pool) == got_pool.generation
    back, step = svc.restore_pool(store, got_pool.g)
    assert step == got_pool.generation
    _same_pool(back, got_pool)
    assert back[6:] == got_pool[6:]
    _same_pool(svc.refresh(back, 512), ref.refresh(want_pool, 512))


def test_pool_from_reference_state_keeps_the_typed_key_flag(graphs):
    g, pg = graphs
    want = ref.make_pool(g, jax.random.key(11), theta=128, slab=128)
    state = {k: np.asarray(v) for k, v in ref.pool_state(want).items()}
    got = svc.pool_from_state(pg, state)
    assert got.typed_key and got.sampler == "dense"
    _same_pool(got, want)
    assert svc.pool_state(got)["scalars"].tolist() == \
        ref.pool_state(want)["scalars"].tolist()
    _same_pool(svc.refresh(got, 256), ref.refresh(want, 256))


def test_restore_from_empty_store(graphs, tmp_path):
    assert svc.restore_pool(CheckpointStore(str(tmp_path)), graphs[1]) == \
        (None, -1)


def _service(pg, **kw):
    kw = dict(dict(theta0=128, max_theta=2048, slab=128), **kw)
    return InfluenceService(pg, prng.key(3), **kw)


def test_serve_matches_reference_and_certifies(graphs):
    """serve() doubles theta for uncertified answers: the reference's
    answers and generations, and generous eps certifies."""
    g, pg = graphs
    qs = [(3, 0.45, ()), (2, 0.45, (1, 2)), (4, 0.0, ())]
    r = ref.InfluenceService(g, jax.random.PRNGKey(3), theta0=128,
                             max_theta=1024, slab=128)
    s = _service(pg, max_theta=1024)
    want = r.serve([ref.Query(k=k, eps=e, excluded=x) for k, e, x in qs])
    got = s.serve([Query(k=k, eps=e, excluded=x) for k, e, x in qs])
    _same(got, want)
    assert s.pool.theta == r.pool.theta
    assert got[0].certified and got[1].certified
    assert got[2].degraded == (not got[2].certified)


def test_generation_drain_and_eviction(graphs):
    s = _service(graphs[1], max_theta=1024)
    t_old = s.admit(Query(k=3))
    old_gen, old_pool = t_old.generation, s.pool
    s.refresh()
    assert s.generation == old_gen + 1 and old_gen in s._pools
    t_new = s.admit(Query(k=3))
    a_old, a_new = s.answer([t_old, t_new])
    assert (a_old.generation, a_new.generation) == (old_gen, s.generation)
    np.testing.assert_array_equal(
        a_old.seeds, svc.answer_one(old_pool, Query(k=3)).seeds)
    assert old_gen not in s._pools
    stale = s.admit(Query(k=3))._replace(generation=old_gen)
    with pytest.raises(StaleGenerationError):
        s.answer([stale])


def test_empty_pool_raises_and_admit_fills(graphs):
    pool = svc.make_pool(graphs[1], prng.key(0), theta=0, slab=128)
    with pytest.raises(EmptyPoolError):
        svc.answer_batch(pool, [Query(k=2)])
    with pytest.raises(EmptyPoolError):
        svc.answer_one(pool, Query(k=2))
    s = _service(graphs[1])
    assert s.pool.theta == 0
    (a,) = s.answer([s.admit(Query(k=2))])
    assert s.pool.theta == 128 and a.generation == 1


def test_admit_validates(graphs):
    s = _service(graphs[1], max_theta=512)
    with pytest.raises(ValueError, match="query k"):
        s.admit(Query(k=0))
    with pytest.raises(ValueError, match="query k"):
        s.admit(Query(k=38))
    with pytest.raises(ValueError, match="budget"):
        s.admit(Query(k=2, budget=100.0))
    with pytest.raises(ValueError, match="out of range"):
        s.answer([s.admit(Query(k=2, excluded=(37,)))])
    with pytest.raises(ValueError, match="unknown solver"):
        _service(graphs[1], solver="heap")


def test_from_pool_service_resumes_identically(graphs):
    s1 = _service(graphs[1])
    (a1,) = s1.answer([s1.admit(Query(k=3))])
    s2 = InfluenceService.from_pool(s1.pool, theta0=128, max_theta=2048)
    assert s2.generation == s1.generation
    (a2,) = s2.answer([s2.admit(Query(k=3))])
    _same([a2], [a1])
    s1.refresh(), s2.refresh()
    np.testing.assert_array_equal(u32(s1.pool.r1), u32(s2.pool.r1))


def test_answer_with_retry_injected_fault(graphs):
    plan = FaultPlan([FaultSpec("service.answer", "raise", at=1)])
    s = _service(graphs[1], fault_plan=plan)
    (want,) = s.answer([s.admit(Query(k=3))])
    sleeps = []
    (got,) = svc.answer_with_retry(s, [s.admit(Query(k=3))], backoff_s=0.5,
                                   sleep_fn=sleeps.append)
    _same([got], [want])
    assert sleeps == [0.5]
    assert [e["site"] for e in plan.events] == ["service.answer"]
    plan2 = FaultPlan([FaultSpec("service.answer", "raise", at=i)
                       for i in range(4)])
    s2 = _service(graphs[1], fault_plan=plan2)
    t = s2.admit(Query(k=2))
    with pytest.raises(InjectedFault):
        svc.answer_with_retry(s2, [t], retries=1, sleep_fn=lambda _: None)


def test_answer_with_retry_stale_generation(graphs):
    s = _service(graphs[1])
    t = s.admit(Query(k=3))
    s.release([t])
    s.refresh()
    with pytest.raises(StaleGenerationError):
        s.answer([t])
    (a,) = svc.answer_with_retry(s, [t])
    assert a.generation == s.generation
    (want,) = s.answer([s.admit(Query(k=3))])
    np.testing.assert_array_equal(a.seeds, want.seeds)


def test_release_drains_generation(graphs):
    s = _service(graphs[1])
    t = s.admit(Query(k=3))
    gen = t.generation
    assert s.inflight(gen) == 1
    s.refresh()
    assert gen in s._pools
    s.release([t])
    assert gen not in s._pools and s.inflight(gen) == 0


def test_serve_deadline_returns_degraded_with_bound(graphs):
    s = _service(graphs[1], max_theta=1 << 14)
    ticks = iter([0.0, 10.0, 20.0, 30.0])
    (a,) = s.serve([Query(k=3, eps=0.0)], deadline_s=5.0,
                   clock=lambda: next(ticks))
    assert a.degraded and not a.certified
    assert a.sigma_lower > 0 and 0 < a.guarantee < 1
    assert s.pool.theta < s.max_theta


def test_serve_max_theta_marks_degraded(graphs):
    s = _service(graphs[1], max_theta=256)
    answers = s.serve([Query(k=3, eps=0.0), Query(k=2, eps=0.45)])
    assert all(a.degraded == (not a.certified) for a in answers)
    assert any(a.degraded for a in answers)


def test_service_stats_and_slab_fill_site(graphs):
    """The slab-fill site fires once per slab and half; the stats count
    the batched solves and refreshes."""
    plan = FaultPlan([])
    svc.make_pool(graphs[1], prng.key(1), theta=256, slab=128, plan=plan)
    assert plan.occurrences("sampler.slab_fill") == 4
    stats = {}
    s = _service(graphs[1], stats=stats)
    s.answer([s.admit(Query(k=2)), s.admit(Query(k=3))])
    s.refresh()
    assert stats["solves"] == 1 and stats["refreshes"] == 2
    assert stats["solve_s"] >= 0 and stats["refresh_s"] >= 0
    assert svc.per_query_state_bytes(8, 3, 1) == \
        ref.per_query_state_bytes(8, 3, 1) == 4 * (8 + 3 + 3 + 1)
