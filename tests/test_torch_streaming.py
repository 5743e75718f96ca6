"""Port parity: the streaming receiver against the reference's fused
and stream Pallas kernels (interpret mode) and scan receiver, and the
float32 thresholds against the jitted reference — all exact."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import streaming as ref  # noqa: E402
from repro.kernels.bucket_insert import (bucket_insert_chunk_pallas,  # noqa: E402
                                         bucket_insert_stream_pallas)
from repro_torch.core import bitset, streaming  # noqa: E402
from repro_torch.kernels import bucket_insert  # noqa: E402
from tests.test_torch_ref import partitionable, to_port, u32, words  # noqa: E402,F401


def _chunk(b, w, c, k, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, 50, c).astype(np.int32)
    rows = words(rng, (c, w), density=0.2)
    covers = words(rng, (b, w), density=0.2)
    counts = rng.integers(0, k + 1, b).astype(np.int32)   # some full
    seeds = rng.integers(-1, 50, (b, k)).astype(np.int32)
    thr = rng.uniform(0, 20, b).astype(np.float32)
    thr[0] = 0.0
    return ids, rows, covers, counts, seeds, thr


@pytest.mark.parametrize("b,w,c,k", [(5, 3, 9, 2), (8, 1, 16, 4),
                                     (3, 7, 5, 1)])
def test_chunk_matches_pallas(b, w, c, k):
    args = _chunk(b, w, c, k, b * w + c)
    want = bucket_insert_chunk_pallas(*map(jnp.asarray, args),
                                      interpret=True)
    ids, rows, covers, counts, seeds, thr = args
    got = bucket_insert.bucket_insert_chunk(
        torch.from_numpy(ids), to_port(rows), to_port(covers),
        torch.from_numpy(counts), torch.from_numpy(seeds),
        torch.from_numpy(thr))
    for a, bb in zip(got, want):
        np.testing.assert_array_equal(u32(a), u32(bb))


@pytest.mark.parametrize("delta", [0.01, 0.077, 0.2, 0.5])
@pytest.mark.parametrize("k", [1, 4, 32, 100, 500])
def test_thresholds_match_jitted_reference(k, delta):
    """The reference evaluates init_state inside jit (lower traced)."""
    f = jax.jit(lambda lo: ref.init_state(k, delta, lo, 4).thresholds)
    for lower in [0.0, 1.0, 17.0, 513.0, 4097.0, 32768.0, 1e6]:
        want = np.asarray(f(jnp.float32(lower)))
        got = streaming.init_state(k, delta, lower, 4,
                                   device="cpu").thresholds.numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("receiver", ["scan", "fused", "pipelined"])
def test_streaming_maxcover_matches_reference(receiver):
    rng = np.random.default_rng(5)
    rows = words(rng, (24, 3), density=0.2)
    ids = np.arange(24, dtype=np.int32)
    ids[[4, 9]] = -1
    lower = float(max(bin(int(x)).count("1") for x in rows[:, 0]))
    want = ref.streaming_maxcover(jnp.asarray(ids), jnp.asarray(rows), 4,
                                  0.077, jnp.float32(lower))
    got = streaming.streaming_maxcover(torch.from_numpy(ids), to_port(rows),
                                       4, 0.077, lower, receiver=receiver)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1]) == int(want[1])
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(u32(a), u32(b))


def test_chunk_stream_and_finalize():
    ids = torch.arange(5, dtype=torch.int32)
    rows = torch.ones((5, 2), dtype=torch.int32)
    i2, r2 = streaming.chunk_stream(ids, rows, 2)
    assert i2.tolist() == [[0, 1], [2, 3], [4, -1]]
    assert r2.shape == (3, 2, 2) and int(r2[2, 1].abs().sum()) == 0
    st = streaming.init_state(2, 0.5, 1.0, 2, device="cpu")
    bad = st._replace(counts=torch.full_like(st.counts, 3))
    with pytest.raises(ValueError, match="overfilled"):
        streaming.finalize(bad)
    want = streaming.streaming_maxcover(ids, rows, 2, 0.5, 1.0)
    for cs in (None, 1, 2, 7):
        got = streaming.streaming_maxcover(ids, rows, 2, 0.5, 1.0,
                                           receiver="pipelined",
                                           chunk_size=cs)
        assert got[0].tolist() == want[0].tolist()
        assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


def _stream(r, c, b, w, k, seed):
    ids, rows, covers, counts, seeds, thr = _chunk(b, w, r * c, k, seed)
    return (ids.reshape(r, c), rows.reshape(r, c, w), covers, counts, seeds,
            thr)


@pytest.mark.parametrize("r,c,b,w,k", [(1, 9, 5, 3, 2), (3, 4, 8, 1, 4),
                                       (7, 5, 3, 7, 1), (2, 16, 63, 33, 3)])
def test_stream_matches_pallas(r, c, b, w, k):
    """Ids of -1 straddle chunk boundaries, some buckets start full."""
    args = _stream(r, c, b, w, k, r * c + b)
    want = bucket_insert_stream_pallas(*map(jnp.asarray, args),
                                       interpret=True)
    ids, rows, covers, counts, seeds, thr = args
    got = bucket_insert.bucket_insert_stream(
        torch.from_numpy(ids), to_port(rows), to_port(covers),
        torch.from_numpy(counts), torch.from_numpy(seeds),
        torch.from_numpy(thr))
    for a, bb in zip(got, want):
        np.testing.assert_array_equal(u32(a), u32(bb))


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_insert_stream_matches_reference(chunk):
    """``insert_stream`` over a chunked stream equals the reference's
    stream kernel, whatever the chunk size; an empty stream leaves the
    state as it was."""
    rng = np.random.default_rng(chunk)
    rows = words(rng, (23, 4), density=0.2)
    ids = rng.integers(-1, 30, 23).astype(np.int32)
    st_ref = ref.init_state(3, 0.2, 6.0, 4)
    want = ref.insert_stream(st_ref, *ref.chunk_stream(
        jnp.asarray(ids), jnp.asarray(rows), chunk), 3, use_kernel=True)
    st = streaming.init_state(3, 0.2, 6.0, 4, device="cpu")
    got = streaming.insert_stream(st, *streaming.chunk_stream(
        torch.from_numpy(ids), to_port(rows), chunk), 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(u32(a), u32(b))
    empty = streaming.insert_stream(
        st, torch.zeros((0, 2), dtype=torch.int32),
        torch.zeros((0, 2, 4), dtype=torch.int32), 3)
    assert all(torch.equal(a, b) for a, b in zip(empty, st))
    with pytest.raises(ValueError, match="chunked stream"):
        streaming.insert_stream(st, torch.from_numpy(ids), to_port(rows), 3)


@pytest.mark.parametrize("w", [1, 33, 4096])
def test_auto_chunk_size_changes_no_result(w):
    """On the CPU the pipelined receiver's "auto" chunk is the whole
    stream (the card's shared memory sets it there), and no chunk size,
    under or over the card's capacity, changes the result."""
    assert bucket_insert.auto_chunk_size(w, 23, "cpu") == 23
    assert bucket_insert.auto_chunk_size(w, 0, "cpu") == 1
    rng = np.random.default_rng(w)
    rows = to_port(words(rng, (23, w), density=0.05))
    ids = torch.from_numpy(rng.integers(-1, 30, 23).astype(np.int32))
    lower = float(bitset.coverage_size(rows).max())
    want = streaming.streaming_maxcover(ids, rows, 3, 0.2, lower)
    for cs in (None, 1, 6, 8, 23, 40):
        got = streaming.streaming_maxcover(ids, rows, 3, 0.2, lower,
                                           receiver="pipelined",
                                           chunk_size=cs)
        assert got[0].tolist() == want[0].tolist()
        assert int(got[1]) == int(want[1])
        assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))
