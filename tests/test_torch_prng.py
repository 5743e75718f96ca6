"""Port parity: the threefry twin against ``jax.random`` in partitionable
mode (exact), including counters whose high word is non-zero."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax._src import prng as jprng  # noqa: E402

from repro_torch.core import prng  # noqa: E402
from repro_torch.core.rrr import xla_cumsum  # noqa: E402
from tests.test_torch_ref import partitionable, port_key  # noqa: E402,F401


def _data(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
def test_key_from_seed(seed):
    k = prng.key(seed)
    np.testing.assert_array_equal([k.k0, k.k1], _data(jax.random.key(seed)))


def test_split_and_fold_in():
    jk = jax.random.key(42)
    k = port_key(jk)
    want = _data(jax.random.split(jk, 5))
    assert [[s.k0, s.k1] for s in k.split(5)] == want.tolist()
    for d in [0, 1, 99, 0xC0FFEE, 0x5EED, 2**32 - 1]:
        f = k.fold_in(d)
        np.testing.assert_array_equal([f.k0, f.k1],
                                      _data(jax.random.fold_in(jk, d)))


@pytest.mark.parametrize("shape", [(1,), (7, 33, 5), (3, 64)])
def test_uniform(shape):
    jk = jax.random.fold_in(jax.random.key(7), 3)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = port_key(jk).uniform(shape, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    start = min(2, want.size)
    flat = port_key(jk).uniform_slice(shape, start, want.size, device="cpu")
    np.testing.assert_array_equal(flat.numpy(), want.reshape(-1)[start:])


@pytest.mark.parametrize("n", [1, 7, 200, 65536, 65537, 262144])
def test_randint(n):
    jk = jax.random.key(5)
    want = np.asarray(jax.random.randint(jk, (500,), 0, n))
    got = port_key(jk).randint((500,), 0, n, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 200, 5000, 100000])
def test_permutation(n):
    jk = jax.random.key(11)
    want = np.asarray(jax.random.permutation(jk, n))
    got = port_key(jk).permutation(n, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_raw_blocks_with_high_counter_word():
    """The (hi, lo) split of a flat index past 2**32 — what the coin
    kernel and ``uniform_at`` use — against the threefry primitive."""
    jk = jax.random.key(3)
    kd = jax.random.key_data(jk)
    hi = np.array([1, 7, 2**31, 0xFFFFFFFF, 0], np.uint32)
    lo = np.array([5, 0, 123, 0xFFFFFFFF, 9], np.uint32)
    y0, y1 = jprng.threefry2x32_p.bind(kd[0], kd[1], jnp.asarray(hi),
                                       jnp.asarray(lo))
    t0, t1 = port_key(jk).block(torch.from_numpy(hi.astype(np.int64)),
                                torch.from_numpy(lo.astype(np.int64)))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(y0))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(y1))
    bits = (np.asarray(y0) ^ np.asarray(y1)) >> 9 | np.uint32(0x3F800000)
    want = bits.view(np.float32) - np.float32(1.0)
    idx = torch.from_numpy((hi.astype(np.int64) << 32) | lo.astype(np.int64))
    np.testing.assert_array_equal(
        port_key(jk).uniform_at(idx).numpy(), want)


@pytest.mark.parametrize("d", [1, 3, 16, 17, 40, 300])
def test_xla_cumsum_matches_jnp_cumsum(d):
    raw = np.random.default_rng(d).uniform(0.1, 1.0, size=(300, d))
    w = (raw / raw.sum(1, keepdims=True)).astype(np.float32)
    w[::3, d // 2:] = 0
    np.testing.assert_array_equal(
        xla_cumsum(torch.from_numpy(w)).numpy(),
        np.asarray(jnp.cumsum(jnp.asarray(w), axis=1)))
