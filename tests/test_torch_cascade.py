"""Port parity: the spread estimate's engines against ``repro``'s on the
same graph, seeds and key — the activation words, the counts and the
spread exactly equal (tolerance zero).  The IC kernel route
(``cascade_ic``, which draws each live edge inside the step and builds
no live-edge plane) runs its plain version on the CPU,
``cascade_step_ic_plain``, which is also held word for word against the
plane route it replaces (``expand_step_plain`` over ``_live_mask``) on
random dense frontiers; its key table against the reference's
``fold_in(fold_in(key, c), s)``; and the padded reverse table, now
scattered on the graph's device, against the reference's.  The engine
triad (``map``, ``packed``, ``kernel``) under IC, LT and WC against the
reference's engine of the same name, with the WC model's coupling
properties and ``cascade_counts``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import cascade as ref_cascade  # noqa: E402
from repro.graphs import csr as ref_csr  # noqa: E402
from repro.graphs import generators as ref_generators  # noqa: E402
from repro_torch.core import bitset, cascade, prng  # noqa: E402
from repro_torch.core.rrr import _coin_chunks  # noqa: E402
from repro_torch.graphs import csr  # noqa: E402
from repro_torch.kernels import ops, rrr_expand  # noqa: E402
from tests.test_torch_ref import (partitionable, port_graph,  # noqa: E402,F401
                                  port_key, u32)


def _graph(kind: str, n: int):
    """A reference graph: ER (avg degree 4), a star (hub 0 points at every
    vertex, p = 1), a reverse star (every vertex points at hub 0: one
    reverse row of n - 1 slots), an edgeless graph, or ER with every
    probability zero."""
    if kind == "er":
        return ref_generators.erdos_renyi(n, 4.0, seed=1)
    if kind == "star":
        return ref_generators.star(n)
    if kind == "reverse star":
        return ref_csr.from_edge_list(np.arange(1, n), np.zeros(n - 1, np.int64),
                                      n, seed=2)
    if kind == "edgeless":
        return ref_csr.from_edge_list(np.zeros(0, np.int64),
                                      np.zeros(0, np.int64), n)
    g = ref_generators.erdos_renyi(n, 4.0, seed=1)
    return ref_csr.from_edge_list(np.asarray(g.indices), np.repeat(
        np.arange(n), np.diff(np.asarray(g.indptr))), n,
        probs=np.zeros(g.num_edges, np.float32))


# (graph, n, num_sims, coin_chunk, max_steps, seeds): every num_sims of
# the lane layout (pad lanes at 1, 31, 33 and 100), coin_chunk 32 and
# chunks small enough that n_chunks > 1 and d_pad > d, hub rows, -1 pads
# and ids past n, one step and a run to the end.
CASES = [
    ("er", 200, 1, 32, 64, [0, 5, -1, 7]),
    ("er", 200, 31, 32, 64, [3, -1, 250, 9]),
    ("er", 200, 32, 32, 64, [1, 2, 3]),
    ("er", 200, 33, 3, 64, [0, 5, -1, 7, 1000]),
    ("er", 200, 64, 32, 64, [10, 20, 30, -1, -1]),
    ("er", 200, 64, 5, 1, [10, 20, 30, -1]),
    ("er", 200, 100, 32, 64, [4, 8, 15, 16, 23, 42]),
    ("er", 200, 100, 3, 1, [4, 8, -1, 200]),
    ("star", 150, 64, 32, 64, [0, -1]),
    ("star", 150, 33, 7, 64, [3, 0]),
    ("reverse star", 150, 64, 32, 64, [1, 2, 3, 4, 5, -1]),
    ("reverse star", 150, 100, 16, 64, list(range(1, 150, 3))),
    ("edgeless", 50, 64, 32, 64, [0, 3, -1]),
    ("zero probs", 120, 33, 32, 64, [0, 1, 2]),
]


@pytest.mark.parametrize("kind,n,num_sims,coin_chunk,max_steps,seeds", CASES)
def test_ic_kernel_route_matches_reference(kind, n, num_sims, coin_chunk,
                                           max_steps, seeds):
    g_ref = _graph(kind, n)
    jk = jax.random.key(7)
    kw = dict(model="IC", num_sims=num_sims, max_steps=max_steps,
              coin_chunk=coin_chunk)
    want = ref_cascade.simulate_cascades(g_ref, np.asarray(seeds), jk,
                                         engine="packed", **kw)
    g, key = port_graph(g_ref), port_key(jk)
    got = cascade.simulate_cascades(g, torch.tensor(seeds), key,
                                    engine="kernel", gather="auto", **kw)
    np.testing.assert_array_equal(u32(got), u32(want))
    s_ref = float(ref_cascade.spread(g_ref, np.asarray(seeds), jk,
                                     engine="packed", **kw))
    assert float(cascade.spread(g, torch.tensor(seeds), key, **kw)) == s_ref


def test_ic_kernel_route_builds_no_live_plane(monkeypatch):
    """IC kernel/auto runs cascade_step_ic and never draws the plane; the
    other gathers still do, with the same words.  LT kernel/auto now
    steps through its own kernel (cascade_step_lt) and draws no plane
    either (tests/test_torch_lt.py holds its other gathers)."""
    g = port_graph(_graph("er", 200))
    key, seeds = prng.key(3), torch.tensor([0, 5, 9])
    draws, steps = [], []
    live_mask, step = cascade._live_mask, rrr_expand.cascade_step_ic
    monkeypatch.setattr(cascade, "_live_mask",
                        lambda *a, **k: draws.append(1) or live_mask(*a, **k))
    monkeypatch.setattr(rrr_expand, "cascade_step_ic",
                        lambda *a, **k: steps.append(1) or step(*a, **k))
    got = cascade.simulate_cascades(g, seeds, key)
    assert steps and not draws
    for gather in ("resident", "streamed"):
        steps.clear()
        assert torch.equal(cascade.simulate_cascades(g, seeds, key,
                                                     gather=gather), got)
        assert draws and not steps
        draws.clear()
    lt_steps, lt_step = [], rrr_expand.cascade_step_lt
    monkeypatch.setattr(rrr_expand, "cascade_step_lt",
                        lambda *a, **k: lt_steps.append(1) or lt_step(*a, **k))
    cascade.simulate_cascades(g, seeds, key, model="LT")
    assert lt_steps and not draws and not steps


def _plane_inputs(kind, n, num_sims, coin_chunk, seed):
    rng = np.random.default_rng(seed)
    g = port_graph(_graph(kind, n))
    nbr, prob, wt = csr.padded_adjacency(g)
    d = nbr.shape[1]
    chunk, n_chunks, d_pad = _coin_chunks(d, coin_chunk)
    w = bitset.num_words(num_sims)
    # dense random words, pad lanes included
    f = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    vis = rng.integers(0, 2**32, (n, w), dtype=np.uint32) & \
        rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    return (nbr, prob, wt, chunk, n_chunks, d_pad,
            torch.from_numpy(f.view(np.int32)),
            torch.from_numpy(vis.view(np.int32)))


@pytest.mark.parametrize("kind,n,num_sims,coin_chunk", [
    ("er", 300, 64, 32), ("er", 300, 33, 3), ("er", 300, 100, 5),
    ("er", 300, 1, 32), ("reverse star", 120, 64, 32),
    ("zero probs", 100, 31, 32)])
def test_step_plain_equals_the_plane_route(kind, n, num_sims, coin_chunk):
    nbr, prob, wt, chunk, n_chunks, d_pad, f, vis = _plane_inputs(
        kind, n, num_sims, coin_chunk, seed=n + num_sims)
    key = prng.key(11).fold_in(num_sims)
    live = cascade._live_mask(nbr, prob, wt, key, model="IC",
                              num_sims=num_sims, chunk=chunk,
                              n_chunks=n_chunks, d_pad=d_pad)
    tbl = torch.nn.functional.pad(torch.where(nbr >= 0, nbr, 0),
                                  (0, d_pad - nbr.shape[1])).contiguous()
    want = rrr_expand.expand_step_plain(f, vis, tbl, live)
    keys = rrr_expand.cascade_keys(key, n_chunks, num_sims, "cpu")
    count = torch.full((1,), -5, dtype=torch.int32)
    got = rrr_expand.cascade_step_ic(f, vis, nbr, prob, keys, chunk,
                                     num_sims, count=count)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(count) == int((got[0] != 0).sum())
    if kind != "zero probs":
        assert int(count) > 0
    assert torch.equal(got[0], rrr_expand.cascade_step_ic_plain(
        f, vis, nbr, prob, keys, chunk, num_sims)[0])


@pytest.mark.parametrize("n_chunks,num_sims", [(1, 64), (3, 33), (7, 100)])
def test_key_table_matches_reference_fold_in(n_chunks, num_sims):
    jk = jax.random.fold_in(jax.random.key(5), 99)
    got = u32(rrr_expand.cascade_keys(port_key(jk), n_chunks, num_sims,
                                      "cpu"))
    want = np.stack([np.stack([np.asarray(jax.random.key_data(
        jax.random.fold_in(jax.random.fold_in(jk, c), s)))
        for s in range(num_sims)]) for c in range(n_chunks)])
    np.testing.assert_array_equal(got, want.astype(np.uint32))


@pytest.mark.parametrize("kind,n", [("er", 300), ("star", 120),
                                    ("reverse star", 120), ("edgeless", 40)])
@pytest.mark.parametrize("pad_to", [None, 2, 9])
def test_padded_adjacency_on_device_matches_reference(kind, n, pad_to):
    g_ref = _graph(kind, n)
    want = ref_csr.padded_adjacency(g_ref, pad_to=pad_to)
    got = csr.padded_adjacency(port_graph(g_ref), pad_to=pad_to)
    for a, b in zip(got, want):
        assert a.dtype in (torch.int32, torch.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cascade_step_refuses_what_the_kernel_does_not_take():
    n, w = 5, 2
    f = torch.zeros((n, w), dtype=torch.int32)
    nbr = torch.zeros((n, 3), dtype=torch.int32)
    prob = torch.zeros((n, 3))
    keys = rrr_expand.cascade_keys(prng.key(0), 1, 64, "cpu")
    with pytest.raises(ValueError, match="chunk keys"):
        rrr_expand.cascade_step_ic(f, f, nbr, prob, keys, 2, 64)
    for num_sims in (65, 32):
        with pytest.raises(ValueError, match="simulations"):
            rrr_expand.cascade_step_ic(f, f, nbr, prob, keys, 4, num_sims)
    with pytest.raises(TypeError):
        rrr_expand.cascade_step_ic(f, f, nbr.long(), prob, keys, 4, 64)
    for lanes in (0, 3, 64):
        with pytest.raises(ValueError, match="lanes"):
            rrr_expand.cascade_step_ic(f, f, nbr, prob, keys, 4, 64,
                                       lanes=lanes)
    with pytest.raises(ValueError, match="shape"):
        rrr_expand.cascade_step_ic(f, f, nbr, prob, keys[:, :32], 4, 64)
    ops.reset_launches()
    rrr_expand.cascade_step_ic(f, f, nbr, prob, keys, 4, 64)
    assert ops.LAUNCHES["cascade_ic"] == 0


# ---------------------------------------------------------------------
# The engine triad under IC, LT and WC, cascade_counts, and WC semantics
# ---------------------------------------------------------------------

def _chain_graph(n):
    return ref_csr.from_edge_list(np.arange(n - 1), np.arange(1, n), n,
                                  probs=np.ones(n - 1, dtype=np.float32))


# (graph, n, num_sims, coin_chunk, seeds): the lane count swept across
# the word boundary (31, 32, 33) and to two words, -1 pads and ids past
# n, hub rows (the star's), several coin chunks.
TRIAD = [
    ("er", 200, 31, 32, [0, 5, -1, 7]),
    ("er", 200, 32, 3, [3, -1, 250, 9]),
    ("er", 120, 33, 32, [1, 2, 3]),
    ("star", 60, 33, 7, [0, -1]),
    ("reverse star", 60, 64, 16, [1, 2, 3, 4, 5, -1]),
]


@pytest.mark.parametrize("model", ["IC", "LT", "WC"])
@pytest.mark.parametrize("kind,n,num_sims,coin_chunk,seeds", TRIAD)
def test_engine_triad_matches_reference(model, kind, n, num_sims,
                                        coin_chunk, seeds):
    """map, packed and kernel (its plain versions on the CPU) give the
    reference's words for the engine of the same name, and the same
    spread."""
    g_ref = _graph(kind, n)
    jk = jax.random.key(13)
    kw = dict(model=model, num_sims=num_sims, coin_chunk=coin_chunk)
    g, key = port_graph(g_ref), port_key(jk)
    for engine in cascade.ENGINES:
        want = ref_cascade.simulate_cascades(g_ref, np.asarray(seeds), jk,
                                             engine=engine, **kw)
        got = cascade.simulate_cascades(g, torch.tensor(seeds), key,
                                        engine=engine, **kw)
        np.testing.assert_array_equal(u32(got), u32(want), err_msg=engine)
        total = np.float32(np.unpackbits(u32(want).view(np.uint8)).sum())
        assert float(cascade.spread(g, torch.tensor(seeds), key,
                                    engine=engine, **kw)) == \
            float(total / np.float32(num_sims))


@pytest.mark.parametrize("gather", ["auto", "resident", "streamed"])
@pytest.mark.parametrize("num_sims,coin_chunk", [(33, 3), (64, 32)])
def test_wc_kernel_gathers_match_reference(gather, num_sims, coin_chunk):
    """WC steps through cascade_ic (auto) or the live plane (resident,
    streamed) with p = the normalized LT weight: the reference's words."""
    g_ref = _graph("er", 200)
    jk = jax.random.key(21)
    kw = dict(model="WC", num_sims=num_sims, coin_chunk=coin_chunk)
    want = ref_cascade.simulate_cascades(g_ref, np.array([0, 9, 44]), jk,
                                         engine="packed", **kw)
    got = cascade.simulate_cascades(port_graph(g_ref),
                                    torch.tensor([0, 9, 44]), port_key(jk),
                                    engine="kernel", gather=gather, **kw)
    np.testing.assert_array_equal(u32(got), u32(want))


def test_wc_kernel_route_is_cascade_ic(monkeypatch):
    """WC kernel/auto runs cascade_step_ic with the LT weights as its
    probabilities and draws no live plane."""
    g = port_graph(_graph("er", 200))
    draws, probs = [], []
    live_mask, step = cascade._live_mask, rrr_expand.cascade_step_ic
    monkeypatch.setattr(cascade, "_live_mask",
                        lambda *a, **k: draws.append(1) or live_mask(*a, **k))
    monkeypatch.setattr(rrr_expand, "cascade_step_ic",
                        lambda *a, **k: probs.append(a[3]) or step(*a, **k))
    cascade.simulate_cascades(g, torch.tensor([0, 5]), prng.key(2),
                              model="WC")
    nbr, _, wt = csr.padded_adjacency(g)
    assert probs and not draws
    assert torch.equal(probs[0], torch.where(nbr >= 0, wt, 0.0))


@pytest.mark.parametrize("model", ["IC", "LT", "WC"])
@pytest.mark.parametrize("engine", ["map", "kernel"])
def test_cascade_counts_match_reference(model, engine):
    g_ref = _graph("er", 120)
    jk = jax.random.key(3)
    kw = dict(model=model, num_sims=33, engine=engine)
    want = np.asarray(ref_cascade.cascade_counts(g_ref, np.array([1, 4]),
                                                 jk, **kw))
    got = cascade.cascade_counts(port_graph(g_ref), torch.tensor([1, 4]),
                                 port_key(jk), **kw)
    assert got.dtype == torch.int32 and got.shape == (33,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 2          # seeds always activate


def test_wc_spread_monotone_in_edge_weight():
    """Shared coins couple the runs: halving every normalized weight can
    only shrink each simulation's activation set, on every engine, and
    the words are the reference's."""
    g_ref = ref_generators.erdos_renyi(60, 5.0, seed=4)
    g_half_ref = ref_csr.CSRGraph(g_ref.indptr, g_ref.indices, g_ref.probs,
                                  g_ref.weights * 0.5)
    jk = jax.random.key(5)
    key = port_key(jk)
    seeds = torch.tensor([0, 1])
    for engine in cascade.ENGINES:
        full, half = (cascade.simulate_cascades(
            port_graph(gr), seeds, key, model="WC", num_sims=64,
            engine=engine) for gr in (g_ref, g_half_ref))
        assert torch.equal(half & full, half)
        np.testing.assert_array_equal(u32(full), u32(
            ref_cascade.simulate_cascades(g_ref, np.array([0, 1]), jk,
                                          model="WC", num_sims=64,
                                          engine=engine)))
        lo = float(cascade.spread(port_graph(g_half_ref), seeds, key,
                                  model="WC", num_sims=64, engine=engine))
        hi = float(cascade.spread(port_graph(g_ref), seeds, key,
                                  model="WC", num_sims=64, engine=engine))
        assert lo < hi


@pytest.mark.parametrize("gather", ["auto", "resident", "streamed"])
def test_wc_weight_one_chain_is_deterministic(gather):
    """Each vertex's single in-edge normalizes to weight 1.0, and a
    uniform in [0, 1) is always below it: every engine fires the whole
    chain from vertex 0 (cascade_ic's skip of p == 0 slots and its coin
    test hold at p = 1)."""
    n = 10
    g = port_graph(_chain_graph(n))
    assert torch.equal(g.weights, torch.ones(n - 1))
    for engine in cascade.ENGINES:
        sp = float(cascade.spread(g, torch.tensor([0]), prng.key(2),
                                  model="WC", num_sims=8, engine=engine,
                                  gather=gather))
        assert sp == float(n)
    assert float(cascade.spread(g, torch.tensor([0]), prng.key(2),
                                model="WC", num_sims=8, max_steps=3,
                                gather=gather)) == 4.0


@pytest.mark.parametrize("model", ["IC", "LT", "WC"])
def test_map_drops_minus_one_pads(model):
    """-1 pads and ids past n are no seeds on the map engine either."""
    g_ref = _graph("er", 50)
    jk = jax.random.key(0)
    g, key = port_graph(g_ref), port_key(jk)
    padded = torch.tensor([3, 7, 11, -1, -1, 50, 999])
    clean = torch.tensor([3, 7, 11])
    kw = dict(model=model, num_sims=32, engine="map")
    got = cascade.simulate_cascades(g, padded, key, **kw)
    assert torch.equal(got, cascade.simulate_cascades(g, clean, key, **kw))
    np.testing.assert_array_equal(u32(got), u32(ref_cascade.simulate_cascades(
        g_ref, padded.numpy(), jk, **kw)))


@pytest.mark.parametrize("model", ["IC", "LT", "WC"])
def test_edgeless_graph_spread_is_seed_count(model):
    g_ref = _graph("edgeless", 5)
    g = port_graph(g_ref)
    for engine in cascade.ENGINES:
        words = cascade.simulate_cascades(g, torch.tensor([0, 3]),
                                          prng.key(0), model=model,
                                          num_sims=16, engine=engine)
        np.testing.assert_array_equal(u32(words), u32(
            ref_cascade.simulate_cascades(g_ref, np.array([0, 3]),
                                          jax.random.key(0), model=model,
                                          num_sims=16, engine=engine)))
        assert float(cascade.spread(g, torch.tensor([0, 3]), prng.key(0),
                                    model=model, num_sims=16,
                                    engine=engine)) == 2.0


def test_engine_and_model_tables_match_reference():
    assert cascade.ENGINES == ref_cascade.ENGINES
    assert cascade.MODELS == ref_cascade.MODELS
    assert cascade.resolve_engine(None) == "kernel"
    with pytest.raises(ValueError):
        cascade.resolve_engine("vectorized")
    with pytest.raises(ValueError):
        cascade.resolve_model("SIR")
