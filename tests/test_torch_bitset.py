"""Port parity: int32-word bitset algebra against ``repro.core.bitset``
(exact: tolerance zero), on random words with the high bit set."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bitset as ref  # noqa: E402
from repro_torch.core import bitset  # noqa: E402
from tests.test_torch_ref import partitionable, to_port, u32, words  # noqa: E402,F401

SHAPES = [(1, 1), (7, 3), (37, 5), (64, 33)]


@pytest.mark.parametrize("n,theta", [(1, 1), (5, 31), (9, 32), (13, 77)])
def test_pack_unpack(n, theta):
    dense = np.random.default_rng(n * theta).random((n, theta)) < 0.5
    got = bitset.pack_bool_matrix(torch.from_numpy(dense))
    want = ref.pack_bool_matrix(jnp.asarray(dense))
    np.testing.assert_array_equal(u32(got), u32(want))
    np.testing.assert_array_equal(bitset.unpack_words(got, theta).numpy(),
                                  dense)


@pytest.mark.parametrize("n,w", SHAPES)
def test_popcount_coverage_gain(n, w):
    rng = np.random.default_rng(n + w)
    x = words(rng, (n, w))
    x[0, 0] = 0xFFFFFFFF
    cov = words(rng, (w,), density=0.2)
    tx, tc = to_port(x), to_port(cov)
    np.testing.assert_array_equal(bitset.popcount(tx).numpy(),
                                  np.asarray(ref.popcount(jnp.asarray(x))))
    np.testing.assert_array_equal(bitset.coverage_size(tx).numpy(),
                                  np.asarray(ref.coverage_size(jnp.asarray(x))))
    np.testing.assert_array_equal(
        bitset.marginal_gain(tx, tc).numpy(),
        np.asarray(ref.marginal_gain(jnp.asarray(x), jnp.asarray(cov))))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_or_reduce(axis):
    x = words(np.random.default_rng(axis), (6, 5, 4), density=0.2)
    np.testing.assert_array_equal(
        u32(bitset.or_reduce(to_port(x), axis)),
        u32(ref.or_reduce(jnp.asarray(x), axis)))


def test_pack_indices():
    idx = [0, 31, 32, 63, 95, 100]
    np.testing.assert_array_equal(u32(bitset.pack_indices(idx, 101)),
                                  ref.pack_indices(np.asarray(idx), 101))


@pytest.mark.parametrize("n,w,density,size", [
    (1, 1, 0.5, 40), (13, 3, 0.2, 500), (37, 5, 0.5, 64), (9, 2, 0.5, 7),
    (20, 4, 0.1, 1)])
def test_packed_nonzero(n, w, density, size):
    """Sample-major (sample, vertex) pairs with the reference's per-plane
    caps: the same pairs in the same order whether the count fits in
    ``size`` or overflows it, tail filled with -1."""
    x = words(np.random.default_rng(n * w), (n, w), density=density)
    s, v = bitset.packed_nonzero(to_port(x), size=size)
    s_ref, v_ref = ref.packed_nonzero(jnp.asarray(x), size=size)
    assert s.dtype == v.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))


@pytest.mark.parametrize("n,w", SHAPES)
def test_union(n, w):
    rng = np.random.default_rng(3 * n + w)
    a, b = words(rng, (n, w)), words(rng, (n, w), density=0.2)
    got = bitset.union(to_port(a), to_port(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        u32(got), u32(ref.union(jnp.asarray(a), jnp.asarray(b))))
