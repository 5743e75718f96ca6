"""Port parity: the expansion step (both layouts) against the Pallas
kernels run in interpret mode, the coin plane against the reference's
per-step coin draw, and the IC step (coins drawn in the step) — the
push over live words, the pull, the composed plane + resident route and
the reference's draw fed through the resident Pallas kernel — exact, at
unaligned n and W, with invalid-slot pads, p = 0 slots and hub rows."""
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


def _option_step(n, df, w, case, seed):
    """A plane step's inputs for the optional ``slots`` and ``lines``:
    rows whose valid slots come first (``slots`` of them) or, for
    ``sentinels``, invalid slots anywhere in a row; a frontier whose
    rows and 32-word lines are often all zero; the reference's inputs
    (fwd_nbr clipped to 0, the sentinel row / a zero mask word at each
    invalid slot) and the port's (for ``slots``, other rows, plane rows
    and mask words past each row's valid slots, which are never read)."""
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, df + 1, n).astype(np.int32)
    if case == "sentinels":
        valid = rng.random((n, df)) < 0.6
    else:
        valid = np.arange(df)[None] < cnt[:, None]
    lines = -(-w // 32)
    frontier = words(rng, (n, w), density=0.2)
    line_on = rng.random((n, lines)) < 0.4
    frontier &= np.where(np.repeat(line_on, 32, 1)[:, :w], 0xFFFFFFFF,
                         0).astype(np.uint32)
    frontier[rng.random(n) < 0.3] = 0
    visited = frontier | words(rng, (n, w), density=0.2)
    nbr = rng.integers(0, n, (n, df)).astype(np.int32)
    rows = 2 * n + 1
    plane = words(rng, (rows, w))
    gidx = rng.integers(0, rows, (n, df)).astype(np.int32)
    gmask = words(rng, (n, df, w))
    ref = (np.where(valid, nbr, 0).astype(np.int32),
           np.where(valid, gidx, rows).astype(np.int32),
           np.where(valid[:, :, None], gmask, 0).astype(np.uint32))
    port = ref if case == "sentinels" else (nbr, gidx, gmask)
    return frontier, visited, plane, ref, port, cnt


def _summary(frontier, extra=None):
    """The line summary of a uint32 [n, W] plane, reduced in numpy:
    pad each row to whole 32-word lines, 1 where a line holds a bit."""
    n, w = frontier.shape
    lines = -(-w // 32)
    padded = np.zeros((n, lines * 32), np.uint32)
    padded[:, :w] = frontier
    out = (padded.reshape(n, lines, 32) != 0).any(2).astype(np.uint8)
    return out if extra is None else out | extra


@pytest.mark.parametrize("layout", ["resident", "streamed"])
@pytest.mark.parametrize("w", [1, 2, 31, 33])
@pytest.mark.parametrize("case", ["slots", "sentinels", "extra lines",
                                  "no lines"])
def test_step_options_match_pallas(layout, w, case):
    """Both wrappers with the optional inputs against the Pallas kernels
    in interpret mode, exactly: a per-row count with valid-first rows
    (and other words past each count, never read), no count with
    sentinels mid-row, a summary with extra set bytes, no summary; the
    emitted summary and count against a reduction of the new frontier's
    32-word lines."""
    n, df = 41, 5
    frontier, visited, plane, ref, port, cnt = _option_step(
        n, df, w, case, 7 * w + len(case))
    rng = np.random.default_rng(w)
    extra = (rng.random((n, -(-w // 32))) < 0.3).astype(np.uint8)
    lines = (None if case == "no lines" else
             _summary(frontier, extra if case == "extra lines" else None))
    opts = dict(
        slots=None if case == "sentinels" else torch.from_numpy(cnt),
        lines=None if lines is None else torch.from_numpy(lines),
        next_lines=torch.full((n, -(-w // 32)), 7, dtype=torch.uint8),
        count=torch.full((1,), -1, dtype=torch.int32))
    f, vis = jnp.asarray(frontier), jnp.asarray(visited)
    if layout == "resident":
        want = rrr_expand_step_resident_pallas(
            f, vis, jnp.asarray(ref[0]), jnp.asarray(ref[1]),
            jnp.asarray(plane), interpret=True)
        got = rrr_expand.rrr_expand_step_resident(
            to_port(frontier), to_port(visited), torch.from_numpy(port[0]),
            torch.from_numpy(port[1]), to_port(plane), **opts)
    else:
        want = rrr_expand_step_pallas(
            f, vis, jnp.asarray(ref[0]), jnp.asarray(ref[2]), interpret=True)
        got = rrr_expand.rrr_expand_step(
            to_port(frontier), to_port(visited), torch.from_numpy(port[0]),
            to_port(port[2]), **opts)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(u32(a), u32(b))
    new_lines = _summary(u32(want[0]))
    np.testing.assert_array_equal(opts["next_lines"].numpy(), new_lines)
    assert int(opts["count"]) == int(new_lines.sum())


def test_line_summary_and_root_lines():
    """line_summary against the numpy reduction at W = 1, 31, 32, 33 and
    1,025; root_lines equals the summary of packed_roots."""
    rng = np.random.default_rng(3)
    for w in (1, 31, 32, 33, 1025):
        f = words(rng, (9, w), density=0.2)
        f[:, rng.random(w) < 0.9] = 0
        np.testing.assert_array_equal(
            rrr_expand.line_summary(to_port(f)).numpy(), _summary(f))
    from repro_torch.core import rrr
    for batch, n in ((32, 5), (2080, 7), (96, 1)):
        roots = torch.from_numpy(rng.integers(0, n, batch))
        w = -(-batch // 32)
        assert torch.equal(rrr.root_lines(roots, n, w),
                           rrr_expand.line_summary(rrr.packed_roots(roots,
                                                                    n)))


def test_step_options_are_checked():
    """The optional inputs' dtype and shape are checked, on the CPU as on
    the card."""
    n, w, df = 6, 33, 2
    f = torch.zeros((n, w), dtype=torch.int32)
    nbr = torch.zeros((n, df), dtype=torch.int32)
    gm = torch.zeros((n, df, w), dtype=torch.int32)
    bad = [dict(slots=torch.zeros(n, dtype=torch.int64)),
           dict(slots=torch.zeros(n + 1, dtype=torch.int32)),
           dict(lines=torch.zeros((n, 2), dtype=torch.int32)),
           dict(lines=torch.zeros((n, 1), dtype=torch.uint8)),
           dict(next_lines=torch.zeros((n, 3), dtype=torch.uint8)),
           dict(count=torch.zeros(2, dtype=torch.int32))]
    for opts in bad:
        with pytest.raises((TypeError, ValueError)):
            rrr_expand.rrr_expand_step(f, f, nbr, gm, **opts)
        with pytest.raises((TypeError, ValueError)):
            rrr_expand.rrr_expand_step_resident(f, f, nbr, nbr, f, **opts)


@pytest.mark.parametrize("n,batch,chunk,n_chunks", [
    (13, 64, 3, 2), (5, 40, 4, 1),
    (7, 96, 2, 3),          # W = 3: no 16-byte chunk, three chunk keys
    (6, 165, 3, 2),         # W = 6: a four-word chunk and a tail of two
])
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


def _tables(nbr, d_pad):
    """(nbr_c, gidx) of the pull's forward slots from a reverse table
    (valid slots first in each row): forward slot (u, s) names the
    reverse slot (v, rslot) with nbr[v, rslot] = u as gidx = v * d_pad +
    rslot; pads are nbr_c = 0, gidx = n * d_pad."""
    n = nbr.shape[0]
    v, r = np.nonzero(nbr >= 0)
    u = nbr[v, r]
    order = np.argsort(u, kind="stable")
    u, v, r = u[order], v[order], r[order]
    out_deg = np.bincount(u, minlength=n)
    df = max(int(out_deg.max()) if u.size else 0, 1)
    pos = np.arange(u.size) - np.repeat(np.cumsum(out_deg) - out_deg, out_deg)
    nbr_c = np.zeros((n, df), np.int32)
    gidx = np.full((n, df), n * d_pad, np.int32)
    nbr_c[u, pos] = v
    gidx[u, pos] = v * d_pad + r
    return nbr_c, gidx


def _ic_step(n, df, w, chunk, n_chunks, seed):
    """A sampler step's inputs: a reverse table of random in-degrees up
    to d (vertex 0 at d, so the slots need n_chunks chunks of chunk),
    invalid slots padded with -1, probabilities with zero slots (the
    padded ones too), a frontier with some words all 32 bits set,
    visited a superset of it, the pull's forward tables, and the chunk
    keys' step subkey.  ``df`` is the mean in-degree asked for."""
    rng = np.random.default_rng(seed)
    d_pad = chunk * n_chunks
    d = d_pad - 1 if n_chunks > 1 else d_pad
    deg = np.minimum(rng.poisson(df, n), d)
    deg[0] = d
    nbr = np.where(np.arange(d)[None] < deg[:, None],
                   rng.integers(0, n, (n, d)), -1).astype(np.int32)
    prob = rng.uniform(0, 0.6, (n, d_pad)).astype(np.float32)
    prob[rng.random((n, d_pad)) < 0.2] = 0.0
    prob[:, d:] = 0.0
    prob[:, :d][nbr < 0] = 0.0
    frontier = words(rng, (n, w), density=0.2)
    frontier[rng.random((n, w)) < 0.1] = np.uint32(0xFFFFFFFF)
    visited = frontier | words(rng, (n, w), density=0.2)
    sub = jax.random.fold_in(jax.random.key(seed), 4)
    return (frontier, visited, nbr, *_tables(nbr, d_pad), prob, sub)


IC_SHAPES = [(37, 5, 3, 3, 2), (130, 3, 1, 4, 1), (8, 1, 4, 2, 3),
             (64, 4, 5, 5, 1)]                   # n, df, W, chunk, n_chunks


def _keys(sub, prob, chunk):
    return [port_key(sub).fold_in(c) for c in range(prob.shape[1] // chunk)]


def _port_ic(frontier, visited, nbr_c, gidx, prob, sub, chunk):
    """The pull's arguments (expand_step_ic_plain) as port tensors."""
    return (to_port(frontier), to_port(visited), torch.from_numpy(nbr_c),
            torch.from_numpy(gidx), torch.from_numpy(prob),
            _keys(sub, prob, chunk), chunk)


def _push(frontier, visited, nbr, prob, keys, chunk):
    """One push step on copies of the dense inputs, through the public
    wrapper -> (new frontier, new visited, next list, frontier after)."""
    n, w = frontier.shape
    f, vis = frontier.clone(), visited.clone()
    nxt = torch.zeros_like(f)
    out = torch.full((n * w,), -7, dtype=torch.int32)
    count = torch.zeros(1, dtype=torch.int32)
    rrr_expand.rrr_expand_push_ic(rrr_expand.live_words(frontier), f, vis,
                                  nbr, prob, keys, chunk, nxt, out, count)
    return nxt, vis, out[:int(count)], f


@pytest.mark.parametrize("n,df,w,chunk,n_chunks", IC_SHAPES)
def test_ic_step_equals_composed_route(n, df, w, chunk, n_chunks):
    """expand_step_ic_plain (the pull) == coin_plane_plain -> resident
    expansion."""
    inputs = _ic_step(n, df, w, chunk, n_chunks, n * w)
    args = _port_ic(*inputs[:2], *inputs[3:], chunk)
    f, vis, nbr_c, gidx, prob, keys, _ = args
    plane = coins.coin_plane_plain(keys, prob, f, chunk).reshape(
        n * chunk * n_chunks, w)
    want = rrr_expand.expand_step_resident_plain(f, vis, nbr_c, gidx, plane)
    got = rrr_expand.expand_step_ic_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((got[0] != 0).sum()) > 0                 # something fired


def _hub_cases():
    """(name, frontier, visited, nbr, prob): the star (hub 0 points at
    every leaf, p = 1: every leaf's push lands on the hub's words) and
    its reverse (every leaf points at 0: one reverse row of n - 1
    slots, past a warp's 32 lanes)."""
    from repro_torch.graphs import csr, generators
    rng = np.random.default_rng(3)
    n, w = 70, 3
    rev = csr.from_edge_list(np.arange(1, n), np.zeros(n - 1, np.int64), n,
                             probs=rng.uniform(0.2, 0.9, n - 1), seed=1,
                             device="cpu")
    out = []
    for name, g in (("star", generators.star(n, device="cpu")),
                    ("reverse star", rev)):
        nbr, prob, _ = csr.padded_adjacency(g)
        frontier = words(rng, (n, w), density=0.2)
        visited = frontier & words(rng, (n, w))
        out.append((name, to_port(frontier), to_port(visited), nbr, prob))
    return out


PUSH_CASES = [f"shape{i}" for i in range(len(IC_SHAPES))] + ["star",
                                                              "reverse star"]


def _push_case(case):
    """A push case's (frontier, visited, nbr, nbr_c, gidx, prob, keys,
    chunk) as port tensors; the hubs use one chunk of their full row."""
    if case.startswith("shape"):
        n, df, w, chunk, n_chunks = IC_SHAPES[int(case[5:])]
        f, vis, nbr, nbr_c, gidx, prob, sub = _ic_step(n, df, w, chunk,
                                                       n_chunks, n + df)
        return (to_port(f), to_port(vis), torch.from_numpy(nbr),
                torch.from_numpy(nbr_c), torch.from_numpy(gidx),
                torch.from_numpy(prob), _keys(sub, prob, chunk), chunk)
    _, f, vis, nbr, prob = dict((c[0], c) for c in _hub_cases())[case]
    nbr_c, gidx = (torch.from_numpy(a) for a in _tables(nbr.numpy(),
                                                        prob.shape[1]))
    keys = [port_key(jax.random.key(6))]
    return f, vis, nbr, nbr_c, gidx, prob, keys, prob.shape[1]


@pytest.mark.parametrize("case", PUSH_CASES)
def test_push_equals_pull_and_composed_route(case):
    """The push (plain, through the wrapper on CPU tensors) == the pull
    == coin_plane_plain -> resident expansion, word for word: W = 1, odd
    W, 1-3 chunks, all-ones words, invalid and p = 0 slots, a star's
    hub target and a reverse star's hub row."""
    f, vis, nbr, nbr_c, gidx, prob, keys, chunk = _push_case(case)
    n, w = f.shape
    got = _push(f, vis, nbr, prob, keys, chunk)
    pull = rrr_expand.expand_step_ic_plain(f, vis, nbr_c, gidx, prob, keys,
                                           chunk)
    plane = coins.coin_plane_plain(keys, prob, f, chunk).reshape(-1, w)
    composed = rrr_expand.expand_step_resident_plain(f, vis, nbr_c, gidx,
                                                     plane)
    for want in (pull, composed):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((got[0] != 0).sum()) > 0                 # something fired
    assert torch.equal(rrr_expand.rrr_expand_step_ic(f, vis, nbr, prob,
                                                     keys, chunk)[0], got[0])


@pytest.mark.parametrize("case", PUSH_CASES)
def test_push_next_list_is_the_next_planes_words(case):
    """The next list holds each non-zero word of the next plane once
    (ascending in the plain version), and the step leaves the frontier
    plane it read all zero."""
    f, vis, nbr, _, _, prob, keys, chunk = _push_case(case)
    nxt, _, listed, f_after = _push(f, vis, nbr, prob, keys, chunk)
    assert torch.equal(listed, rrr_expand.live_words(nxt))
    assert listed.unique().numel() == listed.numel()
    assert not bool(f_after.any())


@pytest.mark.parametrize("case", ["shape0", "reverse star"])
def test_push_plain_in_several_passes(case, monkeypatch):
    """The plain push cut into passes of a few entries (as it runs on
    full-size and hub-row inputs) gives the one-pass result."""
    f, vis, nbr, _, _, prob, keys, chunk = _push_case(case)
    want = _push(f, vis, nbr, prob, keys, chunk)
    monkeypatch.setattr(rrr_expand, "_PLAIN_SLOTS", 3 * nbr.shape[1])
    got = _push(f, vis, nbr, prob, keys, chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_push_leaves_unlisted_words_alone():
    """Words not on the list are neither read nor cleared, and a word
    whose new bits land in a non-zero word of the target plane is not
    appended again."""
    f, vis, nbr, _, _, prob, keys, chunk = _push_case("shape0")
    n, w = f.shape
    listed = rrr_expand.live_words(f)
    half = listed[::2].contiguous()
    f_in, vis_in = f.clone(), vis.clone()
    nxt = torch.zeros_like(f)
    out = torch.empty(n * w, dtype=torch.int32)
    count = torch.zeros(1, dtype=torch.int32)
    rrr_expand.rrr_expand_push_ic(half, f_in, vis_in, nbr, prob, keys, chunk,
                                  nxt, out, count)
    skipped = f.reshape(-1)[listed[1::2].long()]
    assert torch.equal(f_in.reshape(-1)[listed[1::2].long()], skipped)
    assert not bool(f_in.reshape(-1)[half.long()].any())
    only = f.clone()
    only.reshape(-1)[listed[1::2].long()] = 0
    want_next, want_vis = rrr_expand.rrr_expand_step_ic(only, vis, nbr, prob,
                                                        keys, chunk)
    assert torch.equal(nxt, want_next) and torch.equal(vis_in, want_vis)
    first = out[:int(count)].clone()
    again = torch.full_like(out, -1)
    vis2 = vis.clone()
    rrr_expand.rrr_expand_push_ic(half, only.clone(), vis2, nbr, prob, keys,
                                  chunk, nxt, again, count)
    assert int(count) == 0 and torch.equal(nxt, want_next)
    assert first.numel() > 0


@pytest.mark.parametrize("n,df,w,chunk,n_chunks", IC_SHAPES)
def test_ic_step_matches_reference_draw(n, df, w, chunk, n_chunks):
    """The wrapper on CPU tensors == the reference's own coin plane
    (jax.random.uniform per chunk key, _pack_batch_lane) through
    rrr_expand_step_resident_pallas in interpret mode, same gidx."""
    frontier, visited, nbr, nbr_c, gidx, prob, sub = _ic_step(
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
        to_port(frontier), to_port(visited), torch.from_numpy(nbr),
        torch.from_numpy(prob), _keys(sub, prob, chunk), chunk)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(u32(a), u32(b))


def test_ic_step_refuses_keys_that_do_not_cover_the_slots():
    f, vis, nbr, _, _, prob, sub = _ic_step(8, 2, 1, 2, 2, 1)
    args = [to_port(f), to_port(vis), torch.from_numpy(nbr),
            torch.from_numpy(prob), _keys(sub, prob, 2), 2]
    with pytest.raises(ValueError, match="d_pad"):
        rrr_expand.rrr_expand_step_ic(*args[:4], args[4][:1], 2)
    with pytest.raises(TypeError, match="nbr"):
        rrr_expand.rrr_expand_step_ic(args[0], args[1], args[2].long(),
                                      *args[3:])
