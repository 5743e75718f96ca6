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


def compact_case(case):
    """(rows uint32 [m, n, W], k, excluded [m, E]) of sparse rows (about
    1% of the words non-zero, numpy from a seed) with an exact tie across
    two listed rows, for the compact layout's cases."""
    m, n, w, k = (3, 90, 1 if case == "W = 1" else 5 if case == "W = 5"
                  else 7, 6)
    rng = np.random.default_rng(sum(map(ord, case)))
    rows = words(rng, (m, n, w), density=0.2)
    rows[rng.random((m, n, w)) >= 0.01] = 0
    rows[:, 61, 2 % w] |= np.uint32(0x00F0F0F1)   # two listed rows tie
    rows[:, 33] = rows[:, 61]
    listed = [np.flatnonzero(rows[j].any(1)) for j in range(m)]
    ex = np.full((m, 4), -1, np.int32)
    if case == "excluded listed rows":
        ex[0, :3] = [listed[0][0], 33, n + 7]
        ex[1, :1] = listed[1][-1]
    elif case == "every listed row excluded":
        ex = np.full((m, n), -1, np.int32)
        for j in range(m):
            ex[j, :len(listed[j])] = listed[j]
    elif case == "a machine of zero rows":
        rows[1] = 0
    elif case == "tie with a lower zero row":
        rows[:] = 0                             # rows 0 .. 29 stay zero
        rows[:, 30, 0] = rows[:, 70, 0] = 0b1011
        rows[:, 50, 1] = 0b1
        k = 4                                   # after 30 and 50, row 70
    elif case == "k past the listed rows":      # ties zero rows below it
        k = max(len(x) for x in listed) + 5
    return rows, k, ex


COMPACT_CASES = ["sparse", "tie with a lower zero row", "excluded listed rows",
                 "every listed row excluded", "a machine of zero rows",
                 "k past the listed rows", "W = 5", "W = 1"]


@pytest.mark.parametrize("case", COMPACT_CASES)
def test_compact_solve_matches_pallas_and_plain(case):
    """The compact layout's plain solve (the non-zero words listed, then
    each pick swept from the list) equals the reference's resident
    Pallas kernel (interpret mode) and the dense plain solve bit for bit;
    the wrapper takes that layout on these rows and says so."""
    rows, k, ex = compact_case(case)
    port, exc = to_port(rows), torch.from_numpy(ex)
    lists = greedy_pick.compact_rows_plain(port)
    got = greedy_pick.greedy_compact_plain(port, k, exc, lists)
    _assert_same(got, greedy_pick.greedy_plain(port, k, exc))
    stats = {}
    _assert_same(greedy_pick.greedy_maxcover_resident(port, k, exc, stats),
                 got)
    assert stats == dict(layout="compact", nonzero_words=int((rows != 0).sum()),
                         listed_rows=int(rows.any(2).sum()))
    for j in range(rows.shape[0]):
        want = greedy_maxcover_resident_pallas(
            jnp.asarray(rows[j]), k, jnp.asarray(ex[j]), interpret=True)
        _assert_same([o[j] for o in got], want)
    if case == "every listed row excluded":
        assert (got[0] == -1).all() and (got[3] == 0).all()
    if case == "tie with a lower zero row":
        assert got[0].tolist() == [[30, 50, -1, -1]] * 3


def _shuffled(lists, seed):
    """The same list in another order, as the kernel may write it: tiles
    in any slot order (a tile's slots kept together) and the rows'
    entry runs anywhere in the entry array."""
    rng = np.random.default_rng(seed)
    m, n = lists.row_ids.shape
    row_ids, counts, starts = (t.clone() for t in (
        lists.row_ids, lists.counts, lists.starts))
    tiles = lists.tiles.clone()
    for j in range(m):
        slot = 0
        for t in rng.permutation(tiles.shape[1]):
            first, cnt = (int(x) for x in lists.tiles[j, t])
            src = slice(first, first + cnt)
            dst = slice(slot, slot + cnt)
            row_ids[j, dst], counts[j, dst] = (lists.row_ids[j, src],
                                               lists.counts[j, src])
            starts[j, dst] = lists.starts[j, src]
            tiles[j, t, 0] = slot
            slot += cnt
    valid = torch.arange(n)[None] < lists.listed[:, None]
    entries = torch.empty_like(lists.entries)
    at = 0
    for i in rng.permutation(int(valid.sum())):
        s, c = int(starts[valid][i]), int(counts[valid][i])
        entries[at:at + c] = lists.entries[s:s + c]
        flat = valid.nonzero()[i]
        starts[flat[0], flat[1]] = at
        at += c
    return lists._replace(row_ids=row_ids, counts=counts, starts=starts,
                          tiles=tiles, entries=entries)


@pytest.mark.parametrize("m,n,w", [(2, 90, 7), (1, 70, 1), (3, 33, 4)])
def test_compact_rows_plain_lists_every_nonzero_word(m, n, w):
    """The plain compaction lists each row holding a non-zero word once,
    its entries (word index, word) in word order, the slots of a 32-row
    tile together; a list written in another order (tiles and entry
    runs anywhere, as the kernel writes them) compares equal as sets per
    row, and a tile table that misplaces a slot is caught."""
    rng = np.random.default_rng(n)
    rows = words(rng, (m, n, w), density=0.2)
    rows[rng.random((m, n, w)) >= 0.05] = 0
    port = to_port(rows)
    lists = greedy_pick.compact_rows_plain(port)
    nz = np.nonzero(rows)
    assert lists.nonzero_words == len(nz[0])
    np.testing.assert_array_equal(u32(lists.entries[:, 1]), rows[nz])
    np.testing.assert_array_equal(lists.entries[:, 0].numpy(), nz[2])
    assert lists.listed.tolist() == rows.any(2).sum(1).tolist()
    assert lists.tiles[..., 1].sum(1).tolist() == lists.listed.tolist()
    want = greedy_pick.canonical_lists(lists)
    got = greedy_pick.canonical_lists(_shuffled(lists, 1))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if lists.tiles.shape[1] > 1 and int(lists.listed.max()):
        bad = lists.tiles.clone()
        bad[..., 0] += 1
        with pytest.raises(AssertionError, match="tile table"):
            greedy_pick.canonical_lists(lists._replace(tiles=bad))


IMM_WORDS = 8 * 32768 * 1024     # the IMM selector's rows, m = 8


@pytest.mark.parametrize("entries,words,m,pays", [
    (0, 10, 1, True), (1024, 10, 1, True), (1025, 10, 1, False),
    (40_864, IMM_WORDS, 8, True),                 # the IMM run's list
    (8 * (IMM_WORDS // 1024 + 1024), IMM_WORDS, 8, True),
    (8 * (IMM_WORDS // 1024 + 1024) + 1, IMM_WORDS, 8, False),
    (33_554_432, 8 * 4096 * 1024, 8, False),      # a supercritical IMM's
    (16 * (IMM_WORDS // 1024 + 1024), IMM_WORDS, 32, True),
    (16 * (IMM_WORDS // 1024 + 1024) + 1, IMM_WORDS, 32, False)])
def test_compact_layout_pays_up_to_half_the_words(entries, words, m, pays):
    """The compact layout pays while the list holds at most min(m, 16) x
    (words / 1024 + 1024) entries (the rule measured on the card; it
    once allowed half the words)."""
    assert greedy_pick.compact_pays(entries, words, m) is pays
    assert (entries <= greedy_pick.compact_capacity(words, m)) is pays


def test_dense_rows_take_the_dense_sweep():
    """Rows with most words non-zero (a list longer than the compact
    layout pays for) take the dense sweep, and say so."""
    rows = to_port(_rows(2, 2048, 8, 4))
    stats = {}
    got = greedy_pick.greedy_maxcover_resident(rows, 5, None, stats)
    assert stats["layout"] == "dense"
    assert stats["nonzero_words"] > greedy_pick.compact_capacity(rows.numel(),
                                                                 2)
    _assert_same(got, greedy_pick.greedy_plain(
        rows, 5, greedy_pick.excluded_ids(None, 2, "cpu")))
    assert greedy_pick.row_lists(rows).entries is None


def dense_case(case):
    """(rows uint32 [m, n, W], k, excluded [m, E]) of small dense machine
    rows (numpy from a seed): every word non-zero, exclusions (an id past
    n among them), and a tie.  "exhausts": k well past the pick where
    every machine's gains run out; "lasts": k before it; "uneven": as
    "exhausts" but machine 1 holds two rows that can be picked, so its
    gains run out many picks before machine 0's."""
    m, n, w = 2, 40, 2
    rng = np.random.default_rng(7)
    rows = words(rng, (m, n, w), density=0.2)
    rows |= np.uint32(1) << rng.integers(0, 32, (m, n, w)).astype(np.uint32)
    rows[:, 9] = rows[:, 4]                     # a tie: lowest index wins
    if case == "uneven":
        rows[1, 3:] = 0
    ex = np.array([[4, 17, -1], [0, n + 3, 22]], np.int32)
    return rows, 4 if case == "lasts" else 24, ex


# Where the dense picks hand over: after pick p (the compact picks go on
# from p + 1), after the last pick with a positive gain, after pick k - 1
# (no pick left), or never (cap 0).
HANDOVERS = [("exhausts", 0), ("exhausts", 1), ("exhausts", 2),
             ("exhausts", "last gain"), ("exhausts", "never"),
             ("lasts", 0), ("lasts", 1), ("lasts", 2), ("lasts", "k - 1"),
             ("lasts", "never"), ("uneven", 0), ("uneven", 1),
             ("uneven", "last gain"), ("uneven", "never")]


def forced_cap(residual, after, k):
    """(cap, the handover_pick it gives) for a dense solve whose picks
    count ``residual`` (with cap 0)."""
    if after == "never":
        return 0, None
    p = {"last gain": len(residual) - 1, "k - 1": k - 1}.get(after, after)
    cap = residual[p]
    first = next(i for i, r in enumerate(residual) if r <= cap)
    return cap, (first + 1 if first + 1 < k else None)


@pytest.mark.parametrize("case,after", HANDOVERS)
def test_dense_handover_matches_pallas_and_plain(case, after):
    """The dense layout's solve with its handover to the compact picks
    forced at a pick (``cap`` the residual counted there) or never:
    equal to the reference's resident Pallas kernel (interpret mode, per
    machine) and to the plain solve bit for bit; the picks count the
    residual exactly (every untaken row's non-zero words of row &
    ~cover) and stop where every machine's gains ran out."""
    rows, k, ex = dense_case(case)
    port, exc = to_port(rows), torch.from_numpy(ex)
    want = greedy_pick.greedy_plain(port, k, exc)
    full = greedy_pick.greedy_dense_plain(port, k, exc)
    assert full.spent == (case != "lasts") and len(full.residual) == full.p0
    if case == "uneven":        # machine 1 sweeps nothing after pick 2
        assert (want[3] > 0).sum(1).tolist()[1] <= 2 < full.p0 - 4
    assert full.p0 == (int((want[3] > 0).sum(1).max()) if full.spent else k)
    taken = greedy_pick.start(port, k, exc).taken
    cov = torch.zeros_like(want[2])
    for p, count in enumerate(full.residual):   # the count before pick p
        assert count == int(greedy_pick.residual_words(port, cov, taken).sum())
        cov |= want[1][:, p]
        taken[torch.arange(2), want[0][:, p].long().clamp(min=0)] |= (
            want[0][:, p] >= 0)
    cap, pick = forced_cap(full.residual, after, k)
    stats = {}
    got = greedy_pick.greedy_dense(port, k, exc, cap=cap, stats=stats)
    assert stats["handover_pick"] == pick
    assert stats["spent_pick"] == (full.p0 if pick is None and full.spent
                                   else None)
    _assert_same(got, want)
    for j in range(rows.shape[0]):
        ref_out = greedy_maxcover_resident_pallas(
            jnp.asarray(rows[j]), k, jnp.asarray(ex[j]), interpret=True)
        _assert_same([o[j] for o in got], ref_out)


@pytest.mark.parametrize("after", [0, 1, 2])
def test_residual_lists_the_untaken_rows_less_the_cover(after):
    """The masked compaction lists exactly the non-zero words of row &
    ~cover of the rows not taken, each with its word index; its count is
    the dense picks' residual count at the handover at most, and a cap
    below the count raises (no fallback: a count past the handover's cap
    is a fault)."""
    rows, k, ex = dense_case("exhausts")
    port, exc = to_port(rows), torch.from_numpy(ex)
    full = greedy_pick.greedy_dense_plain(port, k, exc)
    state = greedy_pick.greedy_dense_plain(port, k, exc,
                                           cap=full.residual[after])
    assert state.p0 == after + 1
    cov, taken = state.out[2], state.taken
    lists = greedy_pick.residual_lists(port, state, full.residual[after])
    masked = np.where(u32(taken)[:, :, None], 0, rows & ~u32(cov)[:, None])
    nz = np.nonzero(masked)
    assert lists.nonzero_words == len(nz[0]) <= full.residual[after]
    np.testing.assert_array_equal(u32(lists.entries[:, 1]), masked[nz])
    np.testing.assert_array_equal(lists.entries[:, 0].numpy(), nz[2])
    assert lists.listed.tolist() == masked.any(2).sum(1).tolist()
    assert not (np.repeat(u32(taken)[:, :, None], rows.shape[2], 2)[nz]).any()
    with pytest.raises(RuntimeError, match="past the"):
        greedy_pick.residual_lists(port, state, lists.nonzero_words - 1)
