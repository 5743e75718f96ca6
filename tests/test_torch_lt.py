"""Port parity of the LT path: the sampler's push step
(``rrr_expand_push_lt``, kernel ``rrr_expand_lt``) and the cascade's
pull step (``cascade_step_lt``, kernel ``cascade_lt``), which draw each
live in-edge inside the step and build no selection or live-edge plane,
against ``repro`` on the same graphs and keys — words, lists and step
counts exactly equal (tolerance zero).  On the CPU the wrappers run the
kernels' plain versions.  Graphs: ER (rows of at most 16 slots, one
block of the cumulative sum), a star, a reverse star (one row of n - 1
slots: the blocked sum) and rmat (hub rows)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import cascade as ref_cascade  # noqa: E402
from repro.core import rrr as ref_rrr  # noqa: E402
from repro.graphs import csr as ref_csr  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro_torch.core import bitset, cascade, prng, rrr  # noqa: E402
from repro_torch.graphs import csr  # noqa: E402
from repro_torch.kernels import ops, rrr_expand  # noqa: E402
from tests.test_torch_ref import (partitionable, port_graph,  # noqa: E402,F401
                                  port_key, to_port, u32, words)


def _graph(kind: str):
    if kind == "er":
        return ref_gen.erdos_renyi(120, 4.0, seed=1)
    if kind == "star":
        return ref_gen.star(90)
    if kind == "reverse star":
        n = 90
        return ref_csr.from_edge_list(np.arange(1, n), np.zeros(n - 1, np.int64),
                                      n, seed=2)
    return ref_gen.rmat(7, 600, seed=3)           # rmat: hub rows


GRAPHS = ("er", "star", "reverse star", "rmat")


def _ref_step(g_ref, frontier, visited, jkey):
    """The reference's packed LT step (``repro/core/rrr.py:326-345``, its
    selection mask, then ``_expand_packed``) on uint32 planes."""
    nbr, _, wt = ref_csr.padded_adjacency(g_ref)
    fwd_nbr, fwd_rslot = ref_csr.padded_forward_adjacency(g_ref)
    n, d = nbr.shape
    batch = bitset.WORD_BITS * frontier.shape[1]
    r = jax.random.uniform(jkey, (batch, n))
    chosen = jnp.sum(r[:, :, None] >= jnp.cumsum(wt, axis=1)[None], axis=-1)
    in_deg = jnp.sum(nbr >= 0, axis=1)
    slots = jnp.arange(d)
    sel = ((chosen[:, :, None] == slots[None, None])
           & (slots[None, None] < in_deg[None, :, None]))
    mask = ref_rrr._pack_batch_lane(sel, n, d, batch)
    return ref_rrr._expand_packed(jnp.asarray(frontier), jnp.asarray(visited),
                                  fwd_nbr, fwd_rslot, mask, kernel=False)


def _tables(g):
    """The padded LT tables of the plane routes (forward gathers, the
    cascade's ``lt_tables``)."""
    nbr, prob, wt = csr.padded_adjacency(g)
    return rrr._Tables(nbr, prob, wt, *csr.padded_forward_adjacency(g),
                       model="LT", coin_chunk=32)


def _push(fn, lt, f, vis, key):
    """One push step on copies over the CSR tables ``lt``: (next plane,
    visited, sorted next list, frontier after)."""
    n, w = f.shape
    fc, vc, nxt = f.clone(), vis.clone(), torch.zeros_like(f)
    listed = torch.empty(n * w, dtype=torch.int32)
    count = torch.full((1,), -3, dtype=torch.int32)
    fn(rrr_expand.live_words(f), fc, vc, lt.indptr, lt.src, lt.cumw, key,
       nxt, listed, count)
    return nxt, vc, listed[:int(count)].sort().values, fc


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("w,density", [(1, 0.5), (3, 0.1), (5, 0.02)])
def test_push_step_matches_reference_step(kind, w, density):
    """expand_step_lt_push_plain, and the wrapper on the CPU, against the
    reference's packed LT step on random frontiers: the planes word for
    word, the next list the new plane's non-zero words, the frontier it
    read zeroed."""
    g_ref = _graph(kind)
    n = g_ref.num_vertices
    rng = np.random.default_rng(n + w)
    f = words(rng, (n, w), density)
    vis = f | words(rng, (n, w), 0.1)
    jkey = jax.random.fold_in(jax.random.key(4), w)
    want = _ref_step(g_ref, f, vis, jkey)
    lt = csr.lt_reverse(port_graph(g_ref))
    for fn in (rrr_expand.expand_step_lt_push_plain,
               rrr_expand.rrr_expand_push_lt):
        nxt, got_vis, listed, after = _push(fn, lt, to_port(f),
                                            to_port(vis), port_key(jkey))
        np.testing.assert_array_equal(u32(nxt), u32(want[0]))
        np.testing.assert_array_equal(u32(got_vis), u32(want[1]))
        assert listed.tolist() == torch.nonzero(
            nxt.reshape(-1)).reshape(-1).tolist()
        assert not bool(after.any())
    assert u32(want[0]).any()


@pytest.mark.parametrize("kind", GRAPHS)
def test_dense_entry_point_equals_the_plane_route(kind):
    """rrr_expand_step_lt equals the parent's route: the selection plane
    (``rrr._lt_mask``) through the resident expansion."""
    g = port_graph(_graph(kind))
    n = g.num_vertices
    rng = np.random.default_rng(7)
    f, vis = to_port(words(rng, (n, 2), 0.1)), to_port(words(rng, (n, 2)))
    vis |= f
    t = _tables(g)
    lt = csr.lt_reverse(g)
    key = prng.key(9)
    got = rrr_expand.rrr_expand_step_lt(f, vis, lt.indptr, lt.src, lt.cumw,
                                        key)
    plane = rrr._lt_mask(t, key, f).reshape(n * t.d_pad, -1)
    want = rrr_expand.rrr_expand_step_resident(f, vis, t.nbr_c, t.gidx, plane)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _sample(g_ref, jkey, theta, max_steps, sampler, gather="auto"):
    nbr, prob, wt = csr.padded_adjacency(port_graph(g_ref))
    stats = {}
    x = rrr.sample_incidence(
        nbr, prob, wt, port_key(jkey), theta=theta, n=g_ref.num_vertices,
        model="LT", max_steps=max_steps, sampler=sampler,
        fwd=csr.padded_forward_adjacency(port_graph(g_ref)), gather=gather,
        stats=stats)
    return x, stats.get("bfs_steps")


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("max_steps", [1, 3, 64])
def test_kernel_sampler_matches_reference(kind, max_steps):
    """sample_incidence(model="LT", sampler="kernel") — the push loop —
    against the reference's kernel sampler (words, at each max_steps
    cut), and its bfs_steps against the plane loop it replaced
    (``gather="streamed"``, the selection plane a step)."""
    g_ref = _graph(kind)
    jkey = jax.random.key(6)
    nbr, prob, wt = ref_csr.padded_adjacency(g_ref)
    want = ref_rrr.sample_incidence(
        nbr, prob, wt, jkey, theta=64, n=g_ref.num_vertices, model="LT",
        max_steps=max_steps, sampler="kernel",
        fwd=ref_csr.padded_forward_adjacency(g_ref))
    got, steps = _sample(g_ref, jkey, 64, max_steps, "kernel")
    np.testing.assert_array_equal(u32(got), u32(want))
    plane, plane_steps = _sample(g_ref, jkey, 64, max_steps, "kernel",
                                 "streamed")
    assert torch.equal(plane, got) and steps == plane_steps
    assert 1 <= steps <= max_steps


@pytest.mark.parametrize("gather", ["auto", "resident"])
def test_kernel_sampler_builds_no_selection_plane(gather, monkeypatch):
    """LT sampling on the resident layout draws each live in-edge in the
    push (the selection-plane builder made to raise); the streamed layout
    still builds the plane."""
    def no_plane(*args, **kwargs):
        raise AssertionError("the LT push built a selection plane")

    g_ref = _graph("rmat")
    want, _ = _sample(g_ref, jax.random.key(2), 96, 64, "packed")
    monkeypatch.setattr(rrr, "_lt_mask", no_plane)
    got, steps = _sample(g_ref, jax.random.key(2), 96, 64, "kernel", gather)
    assert torch.equal(got, want) and steps >= 2
    with pytest.raises(AssertionError, match="selection plane"):
        _sample(g_ref, jax.random.key(2), 96, 64, "kernel", "streamed")


def test_lt_tables_sort_and_mark_rows_whose_sums_decrease():
    nbr = torch.tensor([[3, 1, -1, -1], [2, -1, -1, -1], [-1] * 4,
                        [0, 1, 2, -1]], dtype=torch.int32)
    cumw = torch.tensor([[0.5, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0],
                         [0.0] * 4, [0.25, 0.75, 0.7499999, 0.7499999]])
    sums, rows = rrr_expand.lt_tables(nbr, cumw)
    assert rows.dtype == torch.int32 and rows.tolist() == [2, 1, 0, -4]
    assert torch.equal(sums[:3], cumw[:3])
    assert torch.equal(sums[3], cumw[3].sort().values)
    # the count is the reference's, whatever the row's order
    v, r = torch.tensor([3, 3, 0, 2]), torch.tensor([0.7499999, 0.75, 0.99,
                                                     0.0])
    for table in (cumw, sums):
        chosen, live = rrr_expand._lt_slots(table, rows, v, r)
        assert chosen.tolist() == [3, 4, 1, 4] and live.tolist() == [
            False, False, True, False]


@pytest.mark.parametrize("kind", ["er", "reverse star", "rmat"])
def test_blocked_cumsum_rows_equal_the_reference(kind):
    """The tables' cumulative weights are the reference's jnp.cumsum bit
    for bit (rows past 16 slots are summed in blocks), each row ascending
    (a marked row sorted)."""
    g_ref = _graph(kind)
    _, _, wt = ref_csr.padded_adjacency(g_ref)
    t = _tables(port_graph(g_ref))
    want = np.asarray(jnp.cumsum(wt, axis=1))
    np.testing.assert_array_equal(
        rrr.xla_cumsum(torch.from_numpy(np.asarray(wt))).numpy(), want)
    np.testing.assert_array_equal(t.cumw.numpy(), np.sort(want, axis=1))
    assert ((t.lt_rows < 0).numpy()
            == (np.diff(want, axis=1) < 0).any(axis=1)).all()


def _cascade_inputs(kind, num_sims, seed):
    g_ref = _graph(kind)
    g = port_graph(g_ref)
    nbr, _, wt = csr.padded_adjacency(g)
    n, w = g.num_vertices, bitset.num_words(num_sims)
    rng = np.random.default_rng(seed)
    f = to_port(words(rng, (n, w), 0.5))            # pad lanes too
    vis = to_port(words(rng, (n, w), 0.1))
    return (g, nbr, wt, *rrr_expand.lt_tables(nbr, rrr.xla_cumsum(wt)), f,
            vis)


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("num_sims", [1, 33, 64, 100])
def test_cascade_step_equals_the_plane_route(kind, num_sims):
    """cascade_step_lt (the plain version on the CPU) against the plane
    route it replaces, rrr_expand_step over the LT live-edge plane
    (``cascade._live_mask``), on dense random frontiers; its count of
    new words."""
    g, nbr, wt, cumw, rows, f, vis = _cascade_inputs(kind, num_sims,
                                                     num_sims)
    key = prng.key(11).fold_in(num_sims)
    d = nbr.shape[1]
    live = cascade._live_mask(nbr, None, wt, key, model="LT",
                              num_sims=num_sims, chunk=d, n_chunks=1, d_pad=d)
    tbl = torch.where(nbr >= 0, nbr, 0).contiguous()
    want = rrr_expand.expand_step_plain(f, vis, tbl, live)
    keys = rrr_expand.lt_cascade_keys(key, num_sims, "cpu")
    count = torch.full((1,), -5, dtype=torch.int32)
    got = rrr_expand.cascade_step_lt(f, vis, nbr, cumw, rows, keys, num_sims,
                                     count=count)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(count) == int((want[0] != 0).sum())
    if num_sims > 1:        # one lane may find no new vertex on a hub graph
        assert int(count) > 0


# (graph, num_sims, max_steps, seeds): pad lanes, one step and a run to
# the end, -1 pads and ids past n.
CASCADES = [("er", 64, 64, [0, 5, -1, 7]), ("er", 33, 1, [3, 250, 9]),
            ("er", 100, 64, [4, 8, 15, 16, 23, 42]),
            ("star", 64, 64, [0, -1]), ("star", 31, 64, [3, 0]),
            ("reverse star", 64, 64, [1, 2, 3, 4, 5]),
            ("rmat", 64, 64, [0, 1, 2, 3]), ("rmat", 100, 2, [5, 9, 64])]


@pytest.mark.parametrize("kind,num_sims,max_steps,seeds", CASCADES)
def test_cascade_routes_match_reference(kind, num_sims, max_steps, seeds):
    """simulate_cascades(model="LT") over the three gathers — auto
    (cascade_lt), resident and streamed (the live-edge plane) — against
    the reference's packed engine: the activation words and the spread."""
    g_ref = _graph(kind)
    jk = jax.random.key(7)
    kw = dict(model="LT", num_sims=num_sims, max_steps=max_steps)
    want = ref_cascade.simulate_cascades(g_ref, np.asarray(seeds), jk,
                                         engine="packed", **kw)
    g, key = port_graph(g_ref), port_key(jk)
    for gather in ("auto", "resident", "streamed"):
        got = cascade.simulate_cascades(g, torch.tensor(seeds), key,
                                        engine="kernel", gather=gather, **kw)
        np.testing.assert_array_equal(u32(got), u32(want))
    s_ref = float(ref_cascade.spread(g_ref, np.asarray(seeds), jk,
                                     engine="packed", **kw))
    assert float(cascade.spread(g, torch.tensor(seeds), key, **kw)) == s_ref


def test_cascade_route_builds_no_live_plane(monkeypatch):
    """LT kernel/auto steps through cascade_step_lt and never draws the
    plane; resident and streamed draw it, with the same words."""
    g = port_graph(_graph("rmat"))
    key, seeds = prng.key(3), torch.tensor([0, 5, 9])
    draws, steps = [], []
    live_mask, step = cascade._live_mask, rrr_expand.cascade_step_lt
    monkeypatch.setattr(cascade, "_live_mask",
                        lambda *a, **k: draws.append(1) or live_mask(*a, **k))
    monkeypatch.setattr(rrr_expand, "cascade_step_lt",
                        lambda *a, **k: steps.append(1) or step(*a, **k))
    got = cascade.simulate_cascades(g, seeds, key, model="LT")
    assert steps and not draws
    for gather in ("resident", "streamed"):
        steps.clear()
        assert torch.equal(cascade.simulate_cascades(
            g, seeds, key, model="LT", gather=gather), got)
        assert draws and not steps
        draws.clear()


@pytest.mark.parametrize("num_sims", [1, 64, 100])
def test_lt_key_table_matches_reference_fold_in(num_sims):
    jk = jax.random.fold_in(jax.random.key(5), 99)
    got = u32(rrr_expand.lt_cascade_keys(port_key(jk), num_sims, "cpu"))
    want = np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(jk, s)))
                     for s in range(num_sims)])
    np.testing.assert_array_equal(got, want.astype(np.uint32))


def test_lt_wrappers_refuse_what_the_kernels_do_not_take():
    n, w = 5, 2
    f = torch.zeros((n, w), dtype=torch.int32)
    nbr = torch.zeros((n, 3), dtype=torch.int32)
    cumw, rows = rrr_expand.lt_tables(nbr, torch.zeros((n, 3)))
    keys = rrr_expand.lt_cascade_keys(prng.key(0), 64, "cpu")
    for num_sims in (65, 32):
        with pytest.raises(ValueError, match="simulations"):
            rrr_expand.cascade_step_lt(f, f, nbr, cumw, rows, keys, num_sims)
    with pytest.raises(TypeError, match="cumw"):
        rrr_expand.cascade_step_lt(f, f, nbr, cumw.double(), rows, keys, 64)
    with pytest.raises(ValueError, match="rows"):
        rrr_expand.cascade_step_lt(f, f, nbr, cumw, rows[:4], keys, 64)
    with pytest.raises(ValueError, match="lanes"):
        rrr_expand.cascade_step_lt(f, f, nbr, cumw, rows, keys, 64, lanes=3)
    with pytest.raises(ValueError, match="keys"):
        rrr_expand.cascade_step_lt(f, f, nbr, cumw, rows, keys[:32], 64)
    words_ = torch.zeros(1, dtype=torch.int32)
    listed = torch.empty(n * w, dtype=torch.int32)
    count = torch.zeros(1, dtype=torch.int32)
    lt = rrr.lt_reverse_padded(nbr, torch.zeros((n, 3)))
    with pytest.raises(ValueError, match="distinct planes"):
        rrr_expand.rrr_expand_push_lt(words_, f, f.clone(), lt.indptr, lt.src,
                                      lt.cumw, prng.key(1), f, listed, count)
    with pytest.raises(ValueError, match="cumw"):
        rrr_expand.rrr_expand_push_lt(words_, f, f.clone(), lt.indptr, lt.src,
                                      lt.cumw[:2], prng.key(1),
                                      torch.zeros_like(f), listed, count)
    ops.reset_launches()
    rrr_expand.cascade_step_lt(f, f, nbr, cumw, rows, keys, 64)
    rrr_expand.rrr_expand_step_lt(f, f, lt.indptr, lt.src, lt.cumw,
                                  prng.key(1))
    assert ops.LAUNCHES["cascade_lt"] == ops.LAUNCHES["rrr_expand_lt"] == 0
