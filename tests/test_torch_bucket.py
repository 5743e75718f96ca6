"""Port parity: ``bucket_gains`` (TPU kernel #9) — the plain version
against the reference's Pallas kernel in interpret mode and its jnp
oracle, exact, for any B and any W (no padding on the port's side),
including the shapes whose word axis the card's kernel splits over a
cluster of blocks or cannot split (W not a multiple of 4)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.bucket import bucket_gains_pallas  # noqa: E402
from repro_torch.kernels import bucket, ops  # noqa: E402
from tests.test_torch_ref import to_port, u32, words  # noqa: E402


@pytest.mark.parametrize("b", [1, 7, 63, 64, 200])
@pytest.mark.parametrize("w", [1, 3, 33, 1024, 2053, 4095, 4096, 4097,
                               65536])
def test_bucket_gains_matches_pallas_and_oracle(b, w):
    rng = np.random.default_rng(b * 10007 + w)
    row = words(rng, (w,), density=0.5)
    covers = words(rng, (b, w), density=0.2)
    covers[0] = 0                       # an empty cover: gain = |row|
    if b > 2:
        covers[1] = 0xFFFFFFFF          # a full cover: gain 0
    want = np.asarray(bucket_gains_pallas(jnp.asarray(row),
                                          jnp.asarray(covers),
                                          interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(ref.bucket_gains_ref(jnp.asarray(row),
                                              jnp.asarray(covers))))
    ops.reset_launches()
    got = bucket.bucket_gains(to_port(row), to_port(covers))
    assert got.dtype == torch.int32 and tuple(got.shape) == (b,)
    np.testing.assert_array_equal(u32(got), want.astype(np.uint32))
    assert int(got[0]) == int(np.unpackbits(row.view(np.uint8)).sum())
    assert ops.LAUNCHES["bucket_gains"] == 0     # CPU: the plain version
    np.testing.assert_array_equal(
        bucket.bucket_gains_plain(to_port(row), to_port(covers)).numpy(),
        got.numpy())
