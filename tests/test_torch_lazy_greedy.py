"""Port parity: the lazy greedy solve (``kernels.lazy_greedy``) against
the reference's ``greedy_maxcover_lazy_pallas`` in interpret mode —
seeds, rows, covered and gains exact at unaligned shapes, with ties
across tiles, exclusions and exhausted gains.  ``tiles_swept`` depends
on the order the sweeps run in and is only held to its range."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import maxcover as ref  # noqa: E402
from repro.kernels.lazy_greedy import greedy_maxcover_lazy_pallas  # noqa: E402
from repro_torch.core import maxcover  # noqa: E402
from repro_torch.kernels import greedy_pick, lazy_greedy  # noqa: E402
from tests.test_torch_maxcover import (COMPACT_CASES, HANDOVERS,  # noqa: E402
                                       compact_case, dense_case, forced_cap)
from tests.test_torch_ref import partitionable, to_port, u32, words  # noqa: E402,F401

TILE = lazy_greedy.TILE_ROWS


def _rows(m, n, w, seed, skew=False):
    rng = np.random.default_rng(seed)
    rows = words(rng, (m, n, w), density=0.2)
    if skew:                                   # few heavy rows, many light
        rows &= np.where(rng.random((m, n, 1)) < 0.1, 0xFFFFFFFF,
                         0x00010001).astype(np.uint32)
    if n > TILE + 3:
        rows[:, TILE + 3] = rows[:, 3]         # a tie across two tiles
    return rows


@pytest.mark.parametrize("m,n,w,k,excl,skew", [
    (1, 37, 3, 5, [-1], False),
    (3, 100, 2, 7, [1, 35, -1, 400], False),
    (2, 6, 1, 9, [0], False),                  # k beyond the useful rows
    (2, 161, 5, 12, [-1], True),
])
def test_lazy_matches_pallas(m, n, w, k, excl, skew):
    rows = _rows(m, n, w, m * n + k, skew)
    *got, swept = lazy_greedy.greedy_maxcover_lazy(to_port(rows), k,
                                                   torch.tensor(excl))
    tiles = lazy_greedy.num_row_tiles(n)
    assert swept.shape == (m,)
    assert all(tiles <= int(s) <= k * tiles for s in swept)
    for j in range(m):
        want = greedy_maxcover_lazy_pallas(jnp.asarray(rows[j]), k,
                                           jnp.asarray(excl, jnp.int32),
                                           interpret=True)
        for a, b in zip([o[j] for o in got], want[:4]):
            np.testing.assert_array_equal(u32(a), u32(b))


def test_skewed_gains_skip_tiles():
    rows = _rows(1, 32 * TILE, 2, 5, skew=True)
    *_, swept = lazy_greedy.greedy_maxcover_lazy(to_port(rows), 10)
    assert int(swept[0]) < 10 * lazy_greedy.num_row_tiles(32 * TILE)


@pytest.mark.parametrize("solver", ["lazy", "scan"])
def test_lazy_solver_matches_reference(solver):
    rows = _rows(1, 80, 4, 3)[0]
    want = ref.greedy_maxcover(jnp.asarray(rows), 6, solver="lazy",
                               excluded=jnp.asarray([2, 40], jnp.int32))
    got = maxcover.greedy_maxcover(to_port(rows), 6, solver=solver,
                                   excluded=[2, 40])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(u32(a), u32(b))


@pytest.mark.parametrize("skew", [False, True])
def test_tiles_needed_counts_the_forced_sweeps(skew):
    """``lazy_plain``'s count of the sweeps an exact schedule makes: all
    tiles in the first pick, at least the largest-bound tile in every
    later one, never more than every tile; skewed gains skip."""
    m, n, k = 2, 20 * TILE + 5, 8
    rows = to_port(_rows(m, n, 3, 11, skew))
    stats = {}
    want = lazy_greedy.lazy_plain(rows, 1, torch.full((m, 1), -1), stats)
    tiles = lazy_greedy.num_row_tiles(n)
    assert stats["tiles_needed"].tolist() == [tiles] * m
    got = lazy_greedy.lazy_plain(rows, k, torch.full((m, 1), -1), stats)
    need = stats["tiles_needed"]
    assert all(tiles + k - 1 <= int(t) <= k * tiles for t in need)
    if skew:
        assert int(need.max()) < k * tiles
    assert torch.equal(got[0][:, :1], want[0])


@pytest.mark.parametrize("skew", [False, True])
def test_nonzero_words_needed_counts_the_needed_popcounts(skew):
    """``lazy_plain``'s count of the non-zero gain words in the tiles an
    exact schedule needs: every non-zero word of the rows not excluded in
    the first pick, at most every word of the needed tiles after k
    picks, and the outputs are those of a run without stats."""
    m, n, w, k = 2, 20 * TILE + 5, 3, 8
    rows = to_port(_rows(m, n, w, 12, skew))
    rows[:, 5:9] = 0                              # rows with no set word
    ex = torch.tensor([[3, -1], [4, 70]], dtype=torch.int32)
    stats = {}
    lazy_greedy.lazy_plain(rows, 1, ex, stats)
    free = torch.ones((m, n), dtype=torch.bool)
    free[0, 3] = free[1, 4] = free[1, 70] = False
    assert stats["nonzero_words_needed"] == int(
        ((rows != 0).sum(2) * free).sum())
    got = lazy_greedy.lazy_plain(rows, k, ex, stats)
    needed = int(stats["tiles_needed"].sum()) * TILE * w
    assert 0 < stats["nonzero_words_needed"] <= needed
    for a, b in zip(got, lazy_greedy.lazy_plain(rows, k, ex)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", COMPACT_CASES)
def test_lazy_compact_solve_matches_pallas_and_plain(case):
    """The compact layout's plain lazy solve (each pick's gains swept
    from the list of non-zero words, the tile bounds as before) equals
    the reference's lazy Pallas kernel (interpret mode) and ``lazy_plain``
    bit for bit, ``tiles_swept`` included (the same in-order schedule);
    the wrapper takes that layout and says so."""
    rows, k, ex = compact_case(case)
    port, exc = to_port(rows), torch.from_numpy(ex)
    lists = greedy_pick.compact_rows_plain(port)
    got = lazy_greedy.lazy_compact_plain(port, k, exc, lists)
    for a, b in zip(got, lazy_greedy.lazy_plain(port, k, exc)):
        np.testing.assert_array_equal(u32(a), u32(b))
    stats = {}
    for a, b in zip(lazy_greedy.greedy_maxcover_lazy(port, k, exc, stats),
                    got):
        np.testing.assert_array_equal(u32(a), u32(b))
    assert stats["layout"] == "compact"
    tiles = lazy_greedy.num_row_tiles(rows.shape[1])
    assert all(tiles <= int(s) <= k * tiles for s in got[4])
    for j in range(rows.shape[0]):
        want = greedy_maxcover_lazy_pallas(jnp.asarray(rows[j]), k,
                                           jnp.asarray(ex[j]),
                                           interpret=True)
        for a, b in zip([o[j] for o in got[:4]], want[:4]):
            np.testing.assert_array_equal(u32(a), u32(b))


def test_entries_needed_counts_the_listed_words_of_needed_tiles():
    """``lazy_plain``'s count of the list entries an exact schedule must
    and-not: every non-zero word of the rows not excluded in the first
    pick, and at least the non-zero gain words after k picks."""
    rows = to_port(_rows(2, 20 * TILE + 5, 3, 13, skew=True))
    rows[:, 5:9] = 0
    ex = torch.tensor([[3, -1], [4, 70]], dtype=torch.int32)
    stats = {}
    lazy_greedy.lazy_plain(rows, 1, ex, stats)
    free = torch.ones(rows.shape[:2], dtype=torch.bool)
    free[0, 3] = free[1, 4] = free[1, 70] = False
    assert stats["entries_needed"] == int(((rows != 0).sum(2) * free).sum())
    lazy_greedy.lazy_plain(rows, 8, ex, stats)
    assert stats["nonzero_words_needed"] <= stats["entries_needed"]


@pytest.mark.parametrize("case,after", HANDOVERS)
def test_lazy_dense_handover_matches_pallas_and_plain(case, after):
    """The dense layout's lazy solve with its handover forced at a pick
    (``cap`` the residual it counted there) or never: seeds, rows,
    covered and gains equal the reference's lazy Pallas kernel
    (interpret mode, per machine) and the plain solve bit for bit, the
    tile bounds carried into the compact picks; ``tiles_swept`` (both
    parts) in range.  Its residual counts bound the exact ones (a tile's
    count is taken when it is swept)."""
    rows, k, ex = dense_case(case)
    port, exc = to_port(rows), torch.from_numpy(ex)
    want = greedy_pick.greedy_plain(port, k, exc)
    full, _, _ = lazy_greedy.lazy_dense_plain(port, k, exc)
    exact = greedy_pick.greedy_dense_plain(port, k, exc)
    assert (full.p0, full.spent) == (exact.p0, exact.spent)
    assert all(a >= b for a, b in zip(full.residual, exact.residual))
    cap, pick = forced_cap(full.residual, after, k)
    stats = {}
    *got, swept = lazy_greedy.lazy_dense(port, k, exc, cap=cap, stats=stats)
    assert stats["handover_pick"] == pick
    tiles = lazy_greedy.num_row_tiles(rows.shape[1])
    assert all(tiles <= int(s) <= k * tiles for s in swept)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(u32(a), u32(b))
    for j in range(rows.shape[0]):
        ref_out = greedy_maxcover_lazy_pallas(jnp.asarray(rows[j]), k,
                                              jnp.asarray(ex[j]),
                                              interpret=True)
        for a, b in zip([o[j] for o in got], ref_out[:4]):
            np.testing.assert_array_equal(u32(a), u32(b))
