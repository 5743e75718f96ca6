"""Port parity: greedy max-k-cover against the reference's resident
Pallas kernel (interpret mode) and scan solver — exact seeds, rows,
covered and gains, with ties, exclusions, k beyond the useful rows and
a machine batch."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import maxcover as ref  # noqa: E402
from repro.kernels.greedy_pick import greedy_maxcover_resident_pallas  # noqa: E402
from repro_torch.core import maxcover  # noqa: E402
from repro_torch.kernels import greedy_pick  # noqa: E402
from tests.test_torch_ref import partitionable, to_port, u32, words  # noqa: E402,F401


def _rows(m, n, w, seed):
    rng = np.random.default_rng(seed)
    rows = words(rng, (m, n, w), density=0.2)
    rows[:, 3 % n] = rows[:, 1 % n]          # a tie: lowest index must win
    return rows


def _assert_same(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(u32(a), u32(b))


@pytest.mark.parametrize("m,n,w,k,excl", [
    (1, 37, 3, 5, [-1]),
    (3, 20, 2, 4, [1, 7, -1, 40]),
    (2, 6, 1, 9, [0]),            # k beyond the useful rows
])
def test_resident_matches_pallas(m, n, w, k, excl):
    rows = _rows(m, n, w, m * n + k)
    got = greedy_pick.greedy_maxcover_resident(to_port(rows), k,
                                               torch.tensor(excl))
    for j in range(m):
        want = greedy_maxcover_resident_pallas(
            jnp.asarray(rows[j]), k, jnp.asarray(excl, jnp.int32),
            interpret=True)
        _assert_same([o[j] for o in got], want)


@pytest.mark.parametrize("solver", ["scan", "resident"])
def test_greedy_maxcover_matches_scan(solver):
    rows = _rows(1, 45, 4, 3)[0]
    want = ref.greedy_maxcover(jnp.asarray(rows), 6, solver="scan",
                               excluded=jnp.asarray([2, 5], jnp.int32))
    got = maxcover.greedy_maxcover(to_port(rows), 6, solver=solver,
                                   excluded=[2, 5])
    _assert_same(got, want)


def test_all_zero_rows_reject_every_pick():
    got = maxcover.greedy_maxcover(torch.zeros((5, 2), dtype=torch.int32), 3)
    assert got.seeds.tolist() == [-1, -1, -1]
    assert got.gains.tolist() == [0, 0, 0]
    assert int(got.coverage) == 0


def test_lazy_oracle_coverage():
    rows = _rows(1, 60, 3, 9)[0]
    seeds, cov = maxcover.lazy_greedy_maxcover_np(rows, 5)
    assert cov == ref.lazy_greedy_maxcover_np(rows, 5)[1]
    got = maxcover.greedy_maxcover(to_port(rows), 5)
    assert int(got.coverage) == cov
    assert maxcover.coverage_of(u32(to_port(rows)), seeds) == cov


def test_unported_solvers_raise():
    """The whole solver quad is ported: "fused" and "lazy" resolve and
    run, equal to the scan solver on a machine batch; only an unknown
    solver raises."""
    rows = to_port(_rows(3, 50, 2, 11))
    want = maxcover.greedy_maxcover(rows, 6, solver="scan", excluded=[4])
    for solver in ("fused", "lazy"):
        assert maxcover.resolve_solver(solver) == solver
        _assert_same(maxcover.greedy_maxcover(rows, 6, solver=solver,
                                              excluded=[4]), want)
    with pytest.raises(ValueError, match="unknown solver"):
        maxcover.resolve_solver("heap")


@pytest.mark.parametrize("solver", ["scan", "fused", "resident", "lazy"])
@pytest.mark.parametrize("n,w,k", [(37, 3, 5), (70, 1, 8)])
def test_batch_matches_reference_batch(solver, n, w, k):
    """B = 3 queries over one shared pool: mixed exclusions (a tie's
    lower row, an id past n, pads) and an empty exclusion; every field
    equals the reference's vmapped solve and the port's one-query
    solve."""
    rows = _rows(1, n, w, n + k)[0]
    ex = np.array([[1, 4, -1, -1], [-1, -1, -1, -1], [2, n + 5, 0, 3]],
                  np.int32)
    want = ref.greedy_maxcover_batch(jnp.asarray(rows), jnp.asarray(ex), k,
                                     solver=solver)
    got = maxcover.greedy_maxcover_batch(to_port(rows), torch.from_numpy(ex),
                                         k, solver=solver)
    _assert_same(got, want)
    for b in range(3):
        one = maxcover.greedy_maxcover(to_port(rows), k, solver=solver,
                                       excluded=ex[b])
        _assert_same([f[b] for f in got], one)


def test_batch_shares_the_pool():
    """The query axis never copies the pool: the batched plain solve
    reads one [n, W] tensor through an expanded view."""
    rows = to_port(_rows(1, 40, 2, 1)[0])
    ex = torch.tensor([[-1], [3]], dtype=torch.int32)
    seen = []
    orig = greedy_pick.greedy_plain

    def spy(r, *a, **kw):
        seen.append(r)
        return orig(r, *a, **kw)
    greedy_pick.greedy_plain = spy
    try:
        greedy_pick.greedy_maxcover_resident_batch(rows, 3, ex)
    finally:
        greedy_pick.greedy_plain = orig
    assert seen[0].shape == (2, 40, 2) and seen[0].stride(0) == 0
    assert seen[0].data_ptr() == rows.data_ptr()
    with pytest.raises(ValueError, match=r"\[B, E\]"):
        greedy_pick.greedy_maxcover_resident_batch(rows, 3, ex[0])


@pytest.mark.parametrize("b,w,budget,want", [
    (8, 4096, 229_000, (8, 1)),      # the serving batch: one group
    (16, 4096, 229_000, (8, 2)),     # past the largest group
    (12, 36, 229_000, (8, 2)),       # a full group, then the other 4
    (13, 36, 229_000, (8, 2)),
    (1, 4096, 229_000, (1, 1)),
    (8, 20000, 229_000, (2, 4)),     # the budget holds two covers
    (3, 70000, 229_000, (1, 3)),     # no cover fits: the kernel refuses
    (5, 4096, 0, (1, 5)),
])
def test_query_groups_plan(b, w, budget, want):
    """The query-axis kernels' group planner: G covers of W words fit
    the shared-memory budget where one does, G <= MAX_GROUP, and the
    groups cover the batch with no group empty."""
    g, groups = greedy_pick.query_groups(b, w, budget)
    assert (g, groups) == want
    assert 1 <= g <= greedy_pick.MAX_GROUP and (groups - 1) * g < b <= g * groups
    assert g * 4 * w <= budget or g == 1


def test_query_groups_needs_a_query():
    with pytest.raises(ValueError, match="at least one query"):
        greedy_pick.query_groups(0, 8, 1000)
