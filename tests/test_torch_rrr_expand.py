"""Port parity: the expansion step (both layouts) against the Pallas
kernels run in interpret mode, the coin plane against the reference's
per-step coin draw, and the fused IC step (coins drawn in the
expansion) against the composed plane + resident route and against the
reference's draw fed through the resident Pallas kernel — exact, at
unaligned n and W, with invalid-slot pads and p = 0 slots."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.rrr import _pack_batch_lane  # noqa: E402
from repro.kernels.rrr_expand import (rrr_expand_step_pallas,  # noqa: E402
                                      rrr_expand_step_resident_pallas)
from repro_torch.kernels import coins, rrr_expand  # noqa: E402
from tests.test_torch_ref import (partitionable, port_key, to_port,  # noqa: E402,F401
                                  u32, words)

SHAPES = [(37, 5, 3), (130, 3, 1), (8, 1, 4)]


def _step(n, df, w, seed):
    rng = np.random.default_rng(seed)
    frontier = words(rng, (n, w), density=0.2)
    visited = frontier | words(rng, (n, w), density=0.2)
    nbr = rng.integers(-1, n, (n, df)).astype(np.int32)
    valid = nbr >= 0
    return rng, frontier, visited, np.where(valid, nbr, 0), valid


@pytest.mark.parametrize("n,df,w", SHAPES)
def test_resident_matches_pallas(n, df, w):
    rng, frontier, visited, nbr_c, valid = _step(n, df, w, n * df)
    rows = n * 2 + 1
    plane = words(rng, (rows, w))
    gidx = np.where(valid, rng.integers(0, rows, (n, df)), rows
                    ).astype(np.int32)
    want = rrr_expand_step_resident_pallas(
        jnp.asarray(frontier), jnp.asarray(visited), jnp.asarray(nbr_c),
        jnp.asarray(gidx), jnp.asarray(plane), interpret=True)
    got = rrr_expand.rrr_expand_step_resident(
        to_port(frontier), to_port(visited), torch.from_numpy(nbr_c),
        torch.from_numpy(gidx), to_port(plane))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(u32(a), u32(b))


@pytest.mark.parametrize("n,df,w", SHAPES)
def test_streamed_matches_pallas(n, df, w):
    rng, frontier, visited, nbr_c, valid = _step(n, df, w, n + df)
    gmask = np.where(valid[:, :, None], words(rng, (n, df, w)), 0
                     ).astype(np.uint32)
    want = rrr_expand_step_pallas(
        jnp.asarray(frontier), jnp.asarray(visited), jnp.asarray(nbr_c),
        jnp.asarray(gmask), interpret=True)
    got = rrr_expand.rrr_expand_step(
        to_port(frontier), to_port(visited), torch.from_numpy(nbr_c),
        to_port(gmask))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(u32(a), u32(b))


@pytest.mark.parametrize("n,batch,chunk,n_chunks", [(13, 64, 3, 2),
                                                     (5, 40, 4, 1)])
def test_coin_plane_matches_reference_draw(n, batch, chunk, n_chunks):
    """plane = (the reference's packed per-chunk coins) & frontier."""
    rng = np.random.default_rng(n)
    d_pad = chunk * n_chunks
    prob = rng.uniform(0, 0.6, (n, d_pad)).astype(np.float32)
    prob[:, -1] = 0.0                                   # padded slot
    w = -(-batch // 32)
    frontier = words(rng, (n, w), density=0.2)
    frontier[:, -1] &= np.uint32((1 << (batch - 32 * (w - 1))) - 1) \
        if batch % 32 else np.uint32(0xFFFFFFFF)
    sub = jax.random.fold_in(jax.random.key(9), 4)
    masks = []
    for c in range(n_chunks):
        u = jax.random.uniform(jax.random.fold_in(sub, c), (batch, n, chunk))
        fire = u < jnp.asarray(prob[:, c * chunk:(c + 1) * chunk])[None]
        masks.append(np.asarray(_pack_batch_lane(fire, n, chunk, batch)))
    want = np.concatenate(masks, axis=1) & frontier[:, None, :]
    keys = [port_key(sub).fold_in(c) for c in range(n_chunks)]
    got = coins.coin_plane(keys, torch.from_numpy(prob), to_port(frontier),
                           chunk)
    np.testing.assert_array_equal(u32(got), want)


def _ic_step(n, df, w, chunk, n_chunks, seed):
    """A sampler step's inputs: forward slots naming (v, reverse slot)
    with a fifth invalid (gidx = n * d_pad, nbr_c = 0), probabilities
    with zero slots (the last one padded), a frontier with some words
    all 32 bits set, and the chunk keys of one step's subkey."""
    rng, frontier, visited, nbr_c, valid = _step(n, df, w, seed)
    d_pad = chunk * n_chunks
    valid &= rng.random((n, df)) > 0.2
    nbr_c = np.where(valid, nbr_c, 0).astype(np.int32)
    gidx = np.where(valid, nbr_c * d_pad + rng.integers(0, d_pad, (n, df)),
                    n * d_pad).astype(np.int32)
    prob = rng.uniform(0, 0.6, (n, d_pad)).astype(np.float32)
    prob[rng.random((n, d_pad)) < 0.2] = 0.0
    prob[:, -1] = 0.0                                   # padded slot
    frontier[rng.random((n, w)) < 0.1] = np.uint32(0xFFFFFFFF)
    sub = jax.random.fold_in(jax.random.key(seed), 4)
    return frontier, visited, nbr_c, gidx, prob, sub


IC_SHAPES = [(37, 5, 3, 3, 2), (130, 3, 1, 4, 1), (8, 1, 4, 2, 3),
             (64, 4, 5, 5, 1)]                   # n, df, W, chunk, n_chunks


def _port_ic(frontier, visited, nbr_c, gidx, prob, sub, chunk):
    keys = [port_key(sub).fold_in(c) for c in range(prob.shape[1] // chunk)]
    return (to_port(frontier), to_port(visited), torch.from_numpy(nbr_c),
            torch.from_numpy(gidx), torch.from_numpy(prob), keys, chunk)


@pytest.mark.parametrize("n,df,w,chunk,n_chunks", IC_SHAPES)
def test_ic_step_equals_composed_route(n, df, w, chunk, n_chunks):
    """expand_step_ic_plain == coin_plane_plain -> resident expansion."""
    args = _port_ic(*_ic_step(n, df, w, chunk, n_chunks, n * w), chunk)
    f, vis, nbr_c, gidx, prob, keys, _ = args
    plane = coins.coin_plane_plain(keys, prob, f, chunk).reshape(
        n * chunk * n_chunks, w)
    want = rrr_expand.expand_step_resident_plain(f, vis, nbr_c, gidx, plane)
    got = rrr_expand.expand_step_ic_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((got[0] != 0).sum()) > 0                 # something fired


@pytest.mark.parametrize("n,df,w,chunk,n_chunks", IC_SHAPES)
def test_ic_step_matches_reference_draw(n, df, w, chunk, n_chunks):
    """The wrapper on CPU tensors == the reference's own coin plane
    (jax.random.uniform per chunk key, _pack_batch_lane) through
    rrr_expand_step_resident_pallas in interpret mode, same gidx."""
    frontier, visited, nbr_c, gidx, prob, sub = _ic_step(
        n, df, w, chunk, n_chunks, n + w)
    batch = 32 * w
    masks = []
    for c in range(n_chunks):
        u = jax.random.uniform(jax.random.fold_in(sub, c), (batch, n, chunk))
        fire = u < jnp.asarray(prob[:, c * chunk:(c + 1) * chunk])[None]
        masks.append(_pack_batch_lane(fire, n, chunk, batch))
    plane = jnp.concatenate(masks, axis=1).reshape(n * chunk * n_chunks, w)
    want = rrr_expand_step_resident_pallas(
        jnp.asarray(frontier), jnp.asarray(visited), jnp.asarray(nbr_c),
        jnp.asarray(gidx), plane, interpret=True)
    got = rrr_expand.rrr_expand_step_ic(
        *_port_ic(frontier, visited, nbr_c, gidx, prob, sub, chunk))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(u32(a), u32(b))


def test_ic_step_refuses_keys_that_do_not_cover_the_slots():
    args = list(_port_ic(*_ic_step(8, 2, 1, 2, 2, 1), 2))
    args[5] = args[5][:1]
    with pytest.raises(ValueError, match="d_pad"):
        rrr_expand.rrr_expand_step_ic(*args)
    args = list(_port_ic(*_ic_step(8, 2, 1, 2, 2, 1), 2))
    args[3] = args[3].long()
    with pytest.raises(TypeError, match="gidx"):
        rrr_expand.rrr_expand_step_ic(*args)
