"""Port parity: ``sample_incidence`` (both port samplers, IC and LT)
against the reference's packed sampler — exact incidence words."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import rrr as ref  # noqa: E402
from repro.graphs import csr as ref_csr  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro_torch.core import rrr  # noqa: E402
from repro_torch.graphs import csr  # noqa: E402
from repro_torch.kernels import coins  # noqa: E402
from tests.test_torch_ref import (partitionable, port_graph, port_key,  # noqa: E402,F401
                                  u32)


def _hub_graph():
    """Everyone points at vertex 0 (in-degree n-1 > 16: blocked cumsum,
    several coin chunks) plus a sparse random part."""
    rng = np.random.default_rng(0)
    n = 40
    src = np.concatenate([np.arange(1, n), rng.integers(0, n, 60)])
    dst = np.concatenate([np.zeros(n - 1, np.int64), rng.integers(0, n, 60)])
    keep = src != dst
    from repro.graphs.csr import from_edge_list
    return from_edge_list(src[keep], dst[keep], n, seed=1)


GRAPHS = {"er": lambda: ref_gen.erdos_renyi(70, 3.0, seed=2),
          "hub": _hub_graph}


def _both(g_ref, jkey, theta, model, coin_chunk, max_steps, sampler,
          gather="auto"):
    nbr, prob, wt = ref_csr.padded_adjacency(g_ref)
    want = ref.sample_incidence(
        nbr, prob, wt, jkey, theta=theta, n=g_ref.num_vertices, model=model,
        max_steps=max_steps, sampler="packed",
        fwd=ref_csr.padded_forward_adjacency(g_ref), coin_chunk=coin_chunk)
    g = port_graph(g_ref)
    t_nbr, t_prob, t_wt = csr.padded_adjacency(g)
    stats = {}
    got = rrr.sample_incidence(
        t_nbr, t_prob, t_wt, port_key(jkey), theta=theta, n=g.num_vertices,
        model=model, max_steps=max_steps, sampler=sampler,
        fwd=csr.padded_forward_adjacency(g), coin_chunk=coin_chunk,
        gather=gather, stats=stats)
    return got, want, stats


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("model", ["IC", "LT"])
@pytest.mark.parametrize("sampler,gather", [("packed", "auto"),
                                            ("kernel", "resident"),
                                            ("kernel", "streamed")])
def test_sample_incidence_matches_reference(graph, model, sampler, gather):
    got, want, stats = _both(GRAPHS[graph](), jax.random.key(3), 96, model,
                             coin_chunk=7, max_steps=64, sampler=sampler,
                             gather=gather)
    np.testing.assert_array_equal(u32(got), u32(want))
    assert stats["bfs_steps"] >= 1


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("gather", ["auto", "resident"])
def test_ic_kernel_sampler_builds_no_coin_plane(graph, gather, monkeypatch):
    """IC with sampler="kernel" on the resident layout draws its coins
    in the expansion step: with the plane builders made to raise it
    still equals the reference."""
    def no_plane(*args, **kwargs):
        raise AssertionError("the fused IC route built a coin plane")

    monkeypatch.setattr(coins, "coin_plane", no_plane)
    monkeypatch.setattr(coins, "coin_plane_plain", no_plane)
    got, want, stats = _both(GRAPHS[graph](), jax.random.key(5), 96, "IC",
                             coin_chunk=7, max_steps=64, sampler="kernel",
                             gather=gather)
    np.testing.assert_array_equal(u32(got), u32(want))
    assert stats["bfs_steps"] >= 2


@pytest.mark.parametrize("max_steps", [1, 2])
def test_max_steps_cutoff(max_steps):
    got, want, stats = _both(ref_gen.erdos_renyi(50, 6.0, seed=4),
                             jax.random.key(8), 64, "IC", coin_chunk=32,
                             max_steps=max_steps, sampler="kernel")
    np.testing.assert_array_equal(u32(got), u32(want))
    assert stats["bfs_steps"] == max_steps


def test_root_words_are_the_nonzero_words_of_packed_roots():
    """The push's first list: repeated roots give one entry a word."""
    roots = torch.tensor([3, 3, 0, 9, 3, 9] * 11 + [4], dtype=torch.int32)
    n = 12
    w = -(-roots.shape[0] // 32)
    got = rrr.root_words(roots, w)
    want = torch.nonzero(rrr.packed_roots(roots, n).reshape(-1)).reshape(-1)
    assert got.dtype == torch.int32
    assert got.tolist() == want.tolist()


def _pull_loop(g, jkey, theta, coin_chunk, max_steps):
    """The IC sampler's loop as a pull: dense frontier and visited, one
    expand_step_ic_plain a BFS step, ended on frontier.any() — same
    roots, same keys as sample_incidence."""
    from repro_torch.kernels import rrr_expand
    nbr, prob, wt = csr.padded_adjacency(g)
    t = rrr._Tables(nbr, prob, wt, *csr.padded_forward_adjacency(g),
                    model="IC", coin_chunk=coin_chunk)
    kr, key = port_key(jkey).split()
    visited = rrr.packed_roots(kr.randint((theta,), 0, t.n, device="cpu"),
                               t.n)
    frontier, step = visited, 0
    while step < max_steps and bool(frontier.any()):
        key, sub = key.split()
        keys = [sub.fold_in(c) for c in range(t.n_chunks)]
        frontier, visited = rrr_expand.expand_step_ic_plain(
            frontier, visited, t.nbr_c, t.gidx, t.prob_p, keys, t.chunk)
        step += 1
    return visited, step


@pytest.mark.parametrize("max_steps", [1, 2, 64])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_push_loop_equals_pull_loop(graph, max_steps):
    """rrr_batch_packed's push loop gives the words and bfs_steps of the
    pull loop it replaced, at the max_steps cuts of
    test_max_steps_cutoff and uncut."""
    g = port_graph(GRAPHS[graph]())
    nbr, prob, wt = csr.padded_adjacency(g)
    stats = {}
    got = rrr.sample_incidence(
        nbr, prob, wt, port_key(jax.random.key(8)), theta=96,
        n=g.num_vertices, model="IC", max_steps=max_steps, sampler="kernel",
        fwd=csr.padded_forward_adjacency(g), coin_chunk=7, stats=stats)
    want, steps = _pull_loop(g, jax.random.key(8), 96, 7, max_steps)
    assert torch.equal(got, want)
    assert stats["bfs_steps"] == steps
    assert steps == max_steps or max_steps == 64


def test_edgeless_graph_is_roots_only():
    from repro.graphs.csr import from_edge_list
    g_ref = from_edge_list(np.array([], np.int64), np.array([], np.int64), 9)
    got, want, stats = _both(g_ref, jax.random.key(1), 32, "IC",
                             coin_chunk=32, max_steps=64, sampler="kernel")
    np.testing.assert_array_equal(u32(got), u32(want))
    assert stats == {}


def test_theta_must_be_word_multiple():
    g = port_graph(ref_gen.erdos_renyi(10, 2.0, seed=0))
    nbr, prob, wt = csr.padded_adjacency(g)
    with pytest.raises(ValueError, match="multiple of 32"):
        rrr.sample_incidence(nbr, prob, wt, port_key(jax.random.key(0)),
                             theta=33, n=10, model="IC",
                             fwd=csr.padded_forward_adjacency(g))


def _dense_both(g_ref, jkey, theta, model, coin_chunk, max_steps=64):
    nbr, prob, wt = ref_csr.padded_adjacency(g_ref)
    want = ref.sample_incidence(
        nbr, prob, wt, jkey, theta=theta, n=g_ref.num_vertices, model=model,
        max_steps=max_steps, sampler="dense", coin_chunk=coin_chunk)
    g = port_graph(g_ref)
    tables = csr.padded_adjacency(g)
    got = {s: rrr.sample_incidence(
        *tables, port_key(jkey), theta=theta, n=g.num_vertices, model=model,
        max_steps=max_steps, sampler=s, fwd=csr.padded_forward_adjacency(g),
        coin_chunk=coin_chunk) for s in ("dense", "packed")}
    return got, want


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("model", ["IC", "LT"])
def test_dense_sampler_matches_reference_dense(graph, model):
    """The dense sampler equals the reference's dense sampler (same
    [batch, n, chunk] coin blocks, same LT uniforms and blocked cumsum)
    and the port's own packed sampler."""
    got, want = _dense_both(GRAPHS[graph](), jax.random.key(5), 96, model,
                            coin_chunk=7)
    np.testing.assert_array_equal(u32(got["dense"]), u32(want))
    np.testing.assert_array_equal(u32(got["dense"]), u32(got["packed"]))
    assert u32(want).any()


@pytest.mark.parametrize("max_steps", [1, 3])
def test_dense_sampler_max_steps(max_steps):
    got, want = _dense_both(ref_gen.erdos_renyi(50, 6.0, seed=4),
                            jax.random.key(8), 64, "IC", coin_chunk=32,
                            max_steps=max_steps)
    np.testing.assert_array_equal(u32(got["dense"]), u32(want))


@pytest.mark.parametrize("sampler", ["dense", "packed", "kernel"])
def test_rrr_batch_matches_reference(sampler):
    """``rrr_batch`` returns the reference's bool [batch, n] visited
    matrix for every sampler (the packed ones unpacked)."""
    g_ref = GRAPHS["hub"]()
    nbr, prob, wt = ref_csr.padded_adjacency(g_ref)
    fwd = ref_csr.padded_forward_adjacency(g_ref)
    roots = np.random.default_rng(1).integers(0, g_ref.num_vertices, 45)
    want = ref.rrr_batch(nbr, prob, wt, jax.numpy.asarray(roots, np.int32),
                         jax.random.key(2), model="IC", sampler="dense",
                         coin_chunk=5)
    g = port_graph(g_ref)
    got = rrr.rrr_batch(*csr.padded_adjacency(g),
                        torch.as_tensor(roots, dtype=torch.int32),
                        port_key(jax.random.key(2)), model="IC",
                        sampler=sampler, fwd=csr.padded_forward_adjacency(g),
                        coin_chunk=5)
    assert got.dtype == torch.bool and tuple(got.shape) == (45, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sampler,model,theta,batch", [
    ("dense", "IC", 300, 64), ("dense", "LT", 100, 32),
    ("kernel", "IC", 200, 96)])
def test_sample_incidence_host_matches_reference(sampler, model, theta,
                                                  batch):
    """Batched host sampling: the same words and the same rounded theta
    (batches keyed ``fold_in(key, i)``, a tail batch rounded to whole
    words and the result trimmed to them)."""
    g_ref = ref_gen.erdos_renyi(60, 4.0, seed=9)
    want, want_theta = ref.sample_incidence_host(
        g_ref, theta, jax.random.key(4), model=model, batch=batch,
        sampler=sampler)
    got, got_theta = rrr.sample_incidence_host(
        port_graph(g_ref), theta, port_key(jax.random.key(4)), model=model,
        batch=batch, sampler=sampler)
    assert got_theta == want_theta == 32 * got.shape[1]
    np.testing.assert_array_equal(u32(got), u32(want))


def test_sampler_codes_follow_the_reference():
    """Pool snapshots store ``SAMPLERS.index``: the codes must be the
    reference's."""
    assert rrr.SAMPLERS == ref.SAMPLERS
    assert rrr.resolve_sampler("dense") == "dense"
    with pytest.raises(ValueError, match="unknown sampler"):
        rrr.resolve_sampler("sparse")


def _rmat_tables():
    from repro_torch.graphs import generators
    g = generators.rmat(7, 700, seed=4, device="cpu")
    return g, csr.padded_adjacency(g)


@pytest.mark.parametrize("sampler,gather", [(s, g) for s in rrr.SAMPLERS
                                            for g in rrr.GATHERS])
def test_reads_forward_names_the_paths_that_read_the_table(sampler, gather):
    """Only the plain packed path and the kernel path's streamed layout
    gather through the forward table; the dense sampler and the push
    never read it."""
    want = sampler == "packed" or (sampler, gather) == ("kernel", "streamed")
    assert rrr.reads_forward(sampler, gather) is want


@pytest.mark.parametrize("model", ["IC", "LT"])
@pytest.mark.parametrize("gather", ["auto", "resident"])
def test_the_push_samples_without_the_forward_table(model, gather):
    """The push takes ``fwd=None`` and draws the same words as with the
    table given."""
    g, tables = _rmat_tables()
    kw = dict(theta=96, n=g.num_vertices, model=model, sampler="kernel",
              gather=gather)
    key = port_key(jax.random.key(6))
    want = rrr.sample_incidence(*tables, key, fwd=csr.padded_forward_adjacency(
        g), **kw)
    got = rrr.sample_incidence(*tables, key, fwd=None, **kw)
    np.testing.assert_array_equal(u32(got), u32(want))
    assert u32(want).any()


@pytest.mark.parametrize("caller", ["sample_incidence", "rrr_batch",
                                    "round"])
@pytest.mark.parametrize("sampler,gather", [("packed", "auto"),
                                            ("kernel", "streamed")])
def test_the_forward_paths_still_need_the_table(caller, sampler, gather):
    g, tables = _rmat_tables()
    n = g.num_vertices
    key = port_key(jax.random.key(6))
    with pytest.raises(ValueError, match=r"needs fwd=\(fwd_nbr, fwd_rslot\)"):
        if caller == "sample_incidence":
            rrr.sample_incidence(*tables, key, theta=64, n=n, model="IC",
                                 sampler=sampler, gather=gather)
        elif caller == "rrr_batch":
            rrr.rrr_batch(*tables, torch.arange(32, dtype=torch.int32), key,
                          model="IC", sampler=sampler, gather=gather)
        else:
            from repro_torch.core import greediris
            greediris.build_round(m=2, n=n, theta=64, k=2, max_degree=0,
                                  sampler=sampler, gather=gather)


@pytest.mark.parametrize("model", ["IC", "LT"])
def test_the_push_round_and_host_sampling_build_no_forward_table(
        model, monkeypatch):
    """On the push the GreediRIS round runs with ``fwd=None`` and
    ``sample_incidence_host`` never builds the forward table, with the
    words and the round's result of the table given."""
    from repro_torch.core import greediris
    g, tables = _rmat_tables()
    n = g.num_vertices
    key = port_key(jax.random.key(7))
    fwd = csr.padded_forward_adjacency(g)
    outs = []
    for f in (fwd, None):
        fn, _, _ = greediris.build_round(m=2, n=n, theta=128, k=3,
                                         max_degree=0, model=model,
                                         sampler="kernel", fwd=f)
        out = fn(*tables, key)
        outs.append([out.seeds.tolist(), int(out.coverage),
                     int(out.global_coverage), int(out.best_local_coverage)])
    assert outs[0] == outs[1]
    want, _ = rrr.sample_incidence_host(g, 96, key, model=model, batch=64,
                                        sampler="packed")

    def refuse(g):
        raise AssertionError("the push built the forward table")

    monkeypatch.setattr(rrr, "padded_forward_adjacency", refuse)
    got, _ = rrr.sample_incidence_host(g, 96, key, model=model, batch=64)
    np.testing.assert_array_equal(u32(got), u32(want))
