"""Port parity: the fused gain sweep + argmax of one pick
(``kernels.topk_gain``) against the reference's ``best_gain_index_pallas``
in interpret mode, and ``solver="fused"`` against the reference's fused
solver — exact, at unaligned shapes with ties and picked rows."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import maxcover as ref  # noqa: E402
from repro.kernels.topk_gain import best_gain_index_pallas  # noqa: E402
from repro_torch.core import maxcover  # noqa: E402
from repro_torch.kernels import topk_gain  # noqa: E402
from tests.test_torch_ref import partitionable, to_port, u32, words  # noqa: E402,F401


@pytest.mark.parametrize("m,n,w,picked_frac", [
    (1, 1, 1, 0.0), (3, 37, 5, 0.3), (2, 130, 33, 0.5), (2, 11, 2, 1.0)])
def test_best_gain_index_matches_pallas(m, n, w, picked_frac):
    rng = np.random.default_rng(m * n + w)
    rows = words(rng, (m, n, w), density=0.2)
    rows[:, n // 2] = rows[:, 0]                  # a tie: lowest index wins
    cov = words(rng, (m, w), density=0.2)
    picked = rng.random((m, n)) < picked_frac
    best, index = topk_gain.best_gain_index(to_port(rows), to_port(cov),
                                            torch.from_numpy(picked))
    for j in range(m):
        want = best_gain_index_pallas(jnp.asarray(rows[j]),
                                      jnp.asarray(cov[j]),
                                      jnp.asarray(picked[j]), interpret=True)
        assert (int(best[j]), int(index[j])) == tuple(map(int, want))


@pytest.mark.parametrize("n,w,k,excl", [(45, 4, 6, [2, 5]), (6, 1, 9, [0]),
                                        (70, 3, 12, [-1])])
def test_fused_solver_matches_reference(n, w, k, excl):
    rows = words(np.random.default_rng(n), (n, w), density=0.2)
    rows[7 % n] = rows[1 % n]
    want = ref.greedy_maxcover(jnp.asarray(rows), k, solver="fused",
                               excluded=jnp.asarray(excl, jnp.int32))
    got = maxcover.greedy_maxcover(to_port(rows), k, solver="fused",
                                   excluded=excl)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(u32(a), u32(b))


def test_no_rows_raise():
    z = torch.zeros((1, 0, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="at least one row"):
        topk_gain.best_gain_index(z, torch.zeros((1, 2), dtype=torch.int32),
                                  torch.zeros((1, 0), dtype=torch.bool))
