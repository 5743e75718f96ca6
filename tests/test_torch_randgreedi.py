"""Port parity: RandGreedi (both aggregators, survivors, truncation)
against ``repro.core.randgreedi`` with the scan solver — exact."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import randgreedi as ref  # noqa: E402
from repro_torch.core import randgreedi  # noqa: E402
from tests.test_torch_ref import (partitionable, port_key, to_port,  # noqa: E402,F401
                                  u32, words)


@pytest.mark.parametrize("aggregator,alpha,survivors,solver", [
    ("streaming", 1.0, None, "scan"),
    ("streaming", 0.5, None, "resident"),
    ("greedy", 1.0, None, "resident"),
    ("streaming", 1.0, (0, 2), "scan"),
    ("greedy", 0.5, (1,), "scan"),
])
def test_matches_reference(aggregator, alpha, survivors, solver):
    rows = words(np.random.default_rng(7), (64, 4), density=0.2)
    jk = jax.random.fold_in(jax.random.key(2), 1)
    want = ref.randgreedi_maxcover(
        jnp.asarray(rows), jk, m=4, k=5, aggregator=aggregator,
        alpha_trunc=alpha, solver="scan", survivors=survivors)
    got = randgreedi.randgreedi_maxcover(
        to_port(rows), port_key(jk), m=4, k=5, aggregator=aggregator,
        alpha_trunc=alpha, solver=solver, survivors=survivors,
        use_kernel=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(u32(a), u32(b))


def test_partition_blocks():
    jk = jax.random.key(4)
    np.testing.assert_array_equal(
        randgreedi.partition_blocks(50, 3, port_key(jk)),
        ref.partition_blocks(50, 3, jk))


def test_survivors_validation():
    rows = torch.zeros((8, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="survivor ids"):
        randgreedi.randgreedi_maxcover(rows, port_key(jax.random.key(0)),
                                       m=2, k=1, survivors=(5,))


@pytest.mark.parametrize("m,n,w,k", [(1, 30, 3, 4), (4, 64, 9, 6),
                                     (3, 17, 2, 20)])
def test_ripples_select_matches_reference(m, n, w, k):
    """The words split into m shards (tail words dropped), one summed
    gain vector per pick; k beyond the useful rows pads with -1."""
    rows = words(np.random.default_rng(m + n), (n, w), density=0.2)
    rows[5] = rows[2]
    want = ref.ripples_select(jnp.asarray(rows), m=m, k=k)
    got = randgreedi.ripples_select(to_port(rows), m=m, k=k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1]) == int(want[1])
