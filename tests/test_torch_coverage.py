"""Port parity: the per-machine gain sweep (``kernels.coverage``, the
Ripples round's kernel) against the reference's ``marginal_gain_pallas``
in interpret mode — exact, at unaligned shapes."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.coverage import marginal_gain_pallas  # noqa: E402
from repro_torch.kernels import coverage, ops  # noqa: E402
from tests.test_torch_ref import partitionable, to_port, words  # noqa: E402,F401


@pytest.mark.parametrize("m,n,w", [(1, 1, 1), (3, 37, 5), (2, 130, 33),
                                   (4, 9, 128)])
def test_marginal_gain_matches_pallas(m, n, w):
    rng = np.random.default_rng(m * n + w)
    rows = words(rng, (m, n, w), density=0.2)
    rows[:, 0] = 0xFFFFFFFF
    cov = words(rng, (m, w), density=0.2)
    cov[0] = 0
    ops.reset_launches()
    got = coverage.marginal_gain(to_port(rows), to_port(cov))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    for j in range(m):
        want = marginal_gain_pallas(jnp.asarray(rows[j]), jnp.asarray(cov[j]),
                                    interpret=True)
        np.testing.assert_array_equal(got[j].numpy(), np.asarray(want))
    assert ops.LAUNCHES["coverage"] == 0        # CPU tensors: plain version


def test_empty_machine_axis():
    got = coverage.marginal_gain(torch.zeros((0, 4, 2), dtype=torch.int32),
                                 torch.zeros((0, 2), dtype=torch.int32))
    assert got.shape == (0, 4)
