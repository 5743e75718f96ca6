"""The receiver kernels' grouped settlement in plain PyTorch
(``bucket_insert_grouped_plain``) against the reference's chunk and
stream Pallas kernels (interpret mode) and the port's scan receiver, all
exact, over both regimes of the full-size cells (buckets that fill with
the first k candidates, buckets that reject nearly everything), the edge
cases of a group, and the passes each regime takes."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.bucket_insert import (bucket_insert_chunk_pallas,  # noqa: E402
                                         bucket_insert_stream_pallas)
from repro_torch.kernels import bucket_insert  # noqa: E402
from tests.test_torch_ref import partitionable, to_port, u32, words  # noqa: E402,F401
from tools.time_receiver import regime_arrays  # noqa: E402

GROUPS = (1, 3, 8, 32)


def _port(ids, rows, covers, counts, seeds, thr):
    return (torch.from_numpy(ids), to_port(rows), to_port(covers),
            torch.from_numpy(counts), torch.from_numpy(seeds),
            torch.from_numpy(thr))


def _reference(args):
    pallas = (bucket_insert_stream_pallas if args[0].ndim == 2
              else bucket_insert_chunk_pallas)
    return pallas(*map(jnp.asarray, args), interpret=True)


def _check(args, groups=GROUPS):
    """Every group size and the scan equal the reference; returns the
    stats of each group size."""
    want = [u32(x) for x in _reference(args)]
    ported = _port(*args)
    if args[0].ndim == 2:
        scan = bucket_insert.bucket_insert_stream_plain(*ported)
    else:
        scan = bucket_insert.bucket_insert_plain(*ported)
    for a, b in zip(scan, want):
        np.testing.assert_array_equal(u32(a), b)
    stats = {}
    for g in groups:
        *got, stats[g] = bucket_insert.bucket_insert_grouped_plain(
            *ported, group=g)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(u32(a), b)
        ids = args[0].reshape(-1)
        groups_with_ids = sum(
            bool((ids[i:i + g] >= 0).any()) for i in range(0, ids.size, g))
        # a pass settles at least one candidate
        assert (stats[g][:, 0] <= groups_with_ids + stats[g][:, 1]).all()
    return stats


def _state(b, w, k):
    covers = np.zeros((b, w), np.uint32)
    counts = np.zeros(b, np.int32)
    seeds = np.full((b, k), -1, np.int32)
    return covers, counts, seeds


def _filling(c, b, w, k, seed):
    """The degree-4 regime: rows of 3 bits, disjoint for the first
    32 W / 3 candidates, thresholds at most 1, so every bucket takes the
    first k candidates and skips the rest."""
    return regime_arrays("filling", c, b, w, k, seed)


def _rejecting(c, b, w, k, seed):
    """The supercritical regime: the first candidate covers every bit of
    the first W - 1 words, the others are dense rows inside them, so each
    bucket takes one candidate and rejects the rest."""
    return regime_arrays("rejecting", c, b, w, k, seed)


@pytest.mark.parametrize("c,b,w,k", [(40, 5, 3, 10), (23, 4, 7, 5),
                                     (64, 3, 4, 33)])
def test_filling_regime(c, b, w, k):
    """Every bucket fills at candidate k - 1, in ceil(k / G) passes and
    with no ambiguous candidate (each row's bits are new)."""
    args = _filling(c, b, w, k, c)
    for g, st in _check(args).items():
        assert st[:, 0].tolist() == [math.ceil(k / g)] * b, g
        assert st[:, 1].tolist() == [0] * b
        assert st[:, 2].tolist() == [k - 1] * b


@pytest.mark.parametrize("c,b,w,k", [(40, 5, 3, 10), (23, 4, 7, 5),
                                     (70, 3, 4, 100)])
def test_rejecting_regime(c, b, w, k):
    """Each bucket accepts the first candidate and rejects the others:
    one candidate a pass alone, and with groups one pass a group plus
    one for the first group's second candidate (its lower bound counts
    the first row, its upper bound does not)."""
    args = _rejecting(c, b, w, k, c)
    for g, st in _check(args).items():
        want = c if g == 1 else math.ceil(c / g) + 1
        assert st[:, 0].tolist() == [want] * b, g
        assert st[:, 1].tolist() == [0 if g == 1 else 1] * b
        assert st[:, 2].tolist() == [-1 if k > 1 else 0] * b


def test_pass_counts_of_the_two_regimes():
    """The replay's two regimes at a small size (B = 63 buckets, k = 100,
    a stream of 8 machines x 100 candidates): filling, 100 / 13 / 4
    passes for groups of 1 / 8 / 32; rejecting, 800 / 101 / 26."""
    for make, want in ((_filling, {1: 100, 8: 13, 32: 4}),
                       (_rejecting, {1: 800, 8: 101, 32: 26})):
        args = _port(*make(800, 63, 10, 100, 1))
        for g, passes in want.items():
            *_, st = bucket_insert.bucket_insert_grouped_plain(*args, group=g)
            assert st[:, 0].tolist() == [passes] * 63, (make.__name__, g)


def test_invalid_ids_and_a_fill_inside_a_group():
    """Ids of -1 inside a group take no pass and bound nothing; k is
    reached in the middle of a group, and the rest of the group and the
    stream are skipped."""
    args = list(_filling(30, 4, 3, 4, 3))
    args[0][[0, 2, 3, 9, 10, 11, 12, 13, 14, 15, 16]] = -1
    stats = _check(tuple(args))
    # valid: 1, 4, 5, 6 fill every bucket (k = 4) at candidate 6
    assert stats[8][:, 2].tolist() == [6] * 4
    assert stats[8][:, 0].tolist() == [1] * 4
    assert stats[3][:, 0].tolist() == [3] * 4      # groups {0-2}, {3-5}, {6-8}
    every_id_invalid = list(args)
    every_id_invalid[0] = np.full(30, -1, np.int32)
    stats = _check(tuple(every_id_invalid))
    assert all(int(st[:, 0].max()) == 0 for st in stats.values())


def test_gain_equal_to_the_threshold():
    """float(gain) == t accepts and is not rejected, at either bound.
    Rows (bits): 0-3, 2-6, 7-11 and 32-36.  At t = 5 row 0 is rejected,
    row 1's upper bound equals t (not rejected) while its lower bound is
    3 (ambiguous), and its exact gain, 5, accepts it; at t = 4 row 0's
    gain equals t and row 1, ambiguous, gains 3."""
    rows = np.zeros((4, 2), np.uint32)
    rows[:3, 0] = [0b1111, 0b1111100, 0b11111 << 7]
    rows[3, 1] = 0b11111
    covers, counts, seeds = _state(3, 2, 4)
    thr = np.array([5.0, 4.0, 1.0], np.float32)
    args = (np.arange(4, dtype=np.int32), rows, covers, counts, seeds, thr)
    stats = _check(args)
    got = bucket_insert.bucket_insert_grouped_plain(*_port(*args), group=8)
    assert got[1].tolist() == [3, 3, 4]
    assert got[2].tolist() == [[1, 2, 3, -1], [0, 2, 3, -1], [0, 1, 2, 3]]
    assert stats[8][:, 1].tolist() == [1, 1, 0]


@pytest.mark.parametrize("t", [0.0, 3.0])
def test_the_same_row_twice_in_a_group(t):
    """The second copy's lower bound is 0: accepted at t = 0, ambiguous
    and then rejected at t > 0."""
    rng = np.random.default_rng(4)
    rows = words(rng, (6, 5), density=0.2)
    rows[3] = rows[1]
    covers, counts, seeds = _state(2, 5, 6)
    thr = np.full(2, t, np.float32)
    args = (np.arange(6, dtype=np.int32), rows, covers, counts, seeds, thr)
    stats = _check(args)
    got = bucket_insert.bucket_insert_grouped_plain(*_port(*args), group=8)
    assert (3 in got[2][0].tolist()) == (t == 0.0)
    if t:
        assert int(stats[8][0, 1]) >= 1


def test_buckets_full_at_the_start():
    """A full bucket takes no pass and keeps its cover and seeds."""
    rng = np.random.default_rng(5)
    ids, rows, covers, counts, seeds, thr = _filling(20, 5, 3, 4, 5)
    covers = words(rng, (5, 3), density=0.2)
    seeds = rng.integers(0, 50, (5, 4)).astype(np.int32)
    counts[[0, 3]] = 4
    stats = _check((ids, rows, covers, counts, seeds, thr))
    for st in stats.values():
        assert st[[0, 3], 0].tolist() == [0, 0]
        assert st[[0, 3], 2].tolist() == [-1, -1]


@pytest.mark.parametrize("r,c,w", [(4, 5, 7), (3, 11, 4), (6, 3, 1)])
def test_groups_straddle_chunks(r, c, w):
    """Streams whose chunks are not multiples of the group (the group
    runs on into the next chunk), W odd and a multiple of 4, ids of -1
    at chunk tails, some buckets full, random thresholds."""
    rng = np.random.default_rng(r * c + w)
    n = r * c
    ids = rng.integers(-1, 40, n).astype(np.int32)
    ids[c - 1::c] = -1
    rows = words(rng, (n, w), density=0.2)
    rows[2] = rows[1]
    b, k = 9, 3
    covers = words(rng, (b, w), density=0.2)
    counts = rng.integers(0, k + 1, b).astype(np.int32)
    seeds = rng.integers(-1, 50, (b, k)).astype(np.int32)
    thr = rng.uniform(0, 12 * w, b).astype(np.float32)
    thr[0] = 0.0
    _check((ids.reshape(r, c), rows.reshape(r, c, w), covers, counts, seeds,
            thr))


@pytest.mark.parametrize("c,b,w,k", [(9, 5, 3, 2), (33, 8, 9, 4),
                                     (17, 3, 1, 40)])
def test_random_chunks(c, b, w, k):
    """Random ids, rows, covers, counts (some full) and thresholds."""
    rng = np.random.default_rng(c * w)
    ids = rng.integers(-1, 50, c).astype(np.int32)
    rows = words(rng, (c, w), density=0.2)
    covers = words(rng, (b, w), density=0.2)
    counts = rng.integers(0, k + 1, b).astype(np.int32)
    seeds = rng.integers(-1, 50, (b, k)).astype(np.int32)
    thr = rng.uniform(0, 20, b).astype(np.float32)
    _check((ids, rows, covers, counts, seeds, thr))


def test_with_stats_on_the_cpu():
    """On the CPU the measured launch is the grouped walk at the kernels'
    group size, its figures laid out as the kernel writes them."""
    args = _port(*_filling(40, 5, 3, 10, 7))
    got = bucket_insert.bucket_insert_with_stats(*args)
    want = bucket_insert.bucket_insert_grouped_plain(
        *args, group=bucket_insert.GROUP)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
    assert got[3].shape == (5, len(bucket_insert.STATS))
    assert torch.equal(got[3][:, :4], want[3])
    assert got[3][:, 3].tolist() == [32] * 5     # the first group, 0-31
    assert got[3][:, 4:].tolist() == [[bucket_insert.GROUP, 1]] * 5
