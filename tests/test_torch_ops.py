"""The port's public kernel entry points (``repro_torch.kernels.ops``,
the reference's eleven names) on CPU tensors against the reference's
``repro.kernels.ops`` calls in interpret mode: the same words made from a
numpy seed, every output equal."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import cascade, rrr  # noqa: E402
from repro_torch.kernels import lazy_greedy, ops  # noqa: E402
from tests.test_torch_ref import partitionable, to_port, u32, words  # noqa: E402,F401


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_array_equal(u32(a), u32(np.asarray(b)))


def test_the_eleven_names_resolve_and_nothing_else():
    assert len(ops.PUBLIC) == 11
    for name in ops.PUBLIC:
        assert callable(getattr(ops, name)) and hasattr(ref_ops, name)
    with pytest.raises(AttributeError):
        ops.no_such_kernel


@pytest.mark.parametrize("n,w", [(1, 1), (37, 5), (130, 33)])
def test_gain_sweeps(n, w):
    rng = np.random.default_rng(n + w)
    rows, cov = words(rng, (n, w), 0.2), words(rng, (w,), 0.2)
    picked = rng.random(n) < 0.3
    ops.reset_launches()
    _same(ops.marginal_gain(to_port(rows), to_port(cov)),
          ref_ops.marginal_gain(jnp.asarray(rows), jnp.asarray(cov)))
    _same(ops.best_gain_index(to_port(rows), to_port(cov),
                              torch.from_numpy(picked)),
          ref_ops.best_gain_index(jnp.asarray(rows), jnp.asarray(cov),
                                  jnp.asarray(picked)))
    covers = words(rng, (7, w), 0.2)
    _same(ops.bucket_gains(to_port(rows[0]), to_port(covers)),
          ref_ops.bucket_gains(jnp.asarray(rows[0]), jnp.asarray(covers)))
    assert not any(ops.LAUNCHES.values())      # CPU: the plain versions


@pytest.mark.parametrize("solver", ["resident", "lazy"])
@pytest.mark.parametrize("n,w,k,ex", [(40, 3, 5, None), (70, 9, 8, 3)])
def test_solvers(solver, n, w, k, ex):
    rng = np.random.default_rng(n * w + k)
    rows = words(rng, (n, w), 0.2)
    excl = (None if ex is None else
            np.concatenate([rng.choice(n, ex, replace=False),
                            [-1]]).astype(np.int32))
    port = getattr(ops, f"greedy_maxcover_{solver}")
    ref = getattr(ref_ops, f"greedy_maxcover_{solver}")
    got = port(to_port(rows), k,
               None if excl is None else torch.from_numpy(excl))
    want = ref(jnp.asarray(rows), k,
               None if excl is None else jnp.asarray(excl))
    # the picks (seeds, rows, covered, gains) are equal; the lazy count
    # of swept tiles counts the port's 32-row tiles, not the reference's
    _same(tuple(got[:4]), tuple(want[:4]))
    assert len(got) == len(want)
    if solver == "lazy":
        tiles = lazy_greedy.num_row_tiles(n)
        assert 0 < int(got[4]) <= k * tiles


@pytest.mark.parametrize("solver", ["resident", "lazy"])
def test_batched_solvers(solver):
    rng = np.random.default_rng(5)
    n, w, k = 50, 4, 6
    rows = words(rng, (n, w), 0.2)
    excl = np.full((3, 4), -1, np.int32)
    excl[1, :2] = [0, 7]
    excl[2, :3] = rng.choice(n, 3, replace=False)
    got = getattr(ops, f"greedy_maxcover_{solver}_batch")(
        to_port(rows), k, torch.from_numpy(excl))
    want = getattr(ref_ops, f"greedy_maxcover_{solver}_batch")(
        jnp.asarray(rows), k, jnp.asarray(excl))
    _same(tuple(got[:4]), tuple(want[:4]))


@pytest.mark.parametrize("n,df,w", [(9, 3, 2), (40, 5, 7)])
def test_expansion_steps(n, df, w):
    rng = np.random.default_rng(n * df + w)
    frontier, visited = words(rng, (n, w), 0.2), words(rng, (n, w), 0.2)
    nbr = rng.integers(0, n, (n, df), dtype=np.int32)
    gmask = words(rng, (n, df, w), 0.5)
    _same(ops.rrr_expand_step(to_port(frontier), to_port(visited),
                              torch.from_numpy(nbr), to_port(gmask),
                              block_v=8),
          ref_ops.rrr_expand_step(jnp.asarray(frontier), jnp.asarray(visited),
                                  jnp.asarray(nbr), jnp.asarray(gmask)))
    rows_ = 2 * n
    gidx = rng.integers(0, rows_ + 1, (n, df), dtype=np.int32)
    plane = words(rng, (rows_, w), 0.5)
    _same(ops.rrr_expand_step_resident(
              to_port(frontier), to_port(visited), torch.from_numpy(nbr),
              torch.from_numpy(gidx), to_port(plane)),
          ref_ops.rrr_expand_step_resident(
              jnp.asarray(frontier), jnp.asarray(visited), jnp.asarray(nbr),
              jnp.asarray(gidx), jnp.asarray(plane)))


def _receiver_state(rng, b, k, w):
    covers = words(rng, (b, w), 0.1)
    counts = rng.integers(0, k, b).astype(np.int32)
    seeds = np.full((b, k), -1, np.int32)
    thr = (np.arange(1, b + 1) * 1.5).astype(np.float32)
    return covers, counts, seeds, thr


@pytest.mark.parametrize("stream", [False, True])
def test_receivers(stream):
    rng = np.random.default_rng(11 + stream)
    b, k, w, c = 6, 4, 3, 10
    shape = (3, c) if stream else (c,)
    ids = rng.integers(-1, 100, shape).astype(np.int32)
    rows = words(rng, (*shape, w), 0.3)
    covers, counts, seeds, thr = _receiver_state(rng, b, k, w)
    name = "bucket_insert_stream" if stream else "bucket_insert_chunk"
    got = getattr(ops, name)(torch.from_numpy(ids), to_port(rows),
                             to_port(covers), torch.from_numpy(counts),
                             torch.from_numpy(seeds), torch.from_numpy(thr))
    want = getattr(ref_ops, name)(*map(jnp.asarray, (ids, rows, covers,
                                                     counts, seeds, thr)))
    _same(tuple(got), tuple(want))


def test_model_aliases():
    assert rrr.Model.__args__ == ("IC", "LT")
    assert cascade.Model.__args__ == ("IC", "LT", "WC")
