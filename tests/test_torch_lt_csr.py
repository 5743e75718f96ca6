"""The LT push over the graph's reverse CSR (``graphs.csr.lt_reverse``,
``rrr_expand_push_lt``), which reads no padded table, against ``repro``:
the CSR tables hold each row's ``deg`` smallest padded sums of the
reference's ``jnp.cumsum`` (tolerance zero), every draw picks the
reference's slot, the push's words equal the reference's packed LT
step, and the LT kernel path of ``imm``, the round and the sampler
builds no [n, d_max] table.  Graphs: those of ``test_torch_lt.py``, a
graph whose padded tails dip an ulp below their rows' last sums
(``dips``: a hub of 5,000 in-edges pads rows of 300 to 2,600), one
whose row's own sums fall (``falls``: weights below an ulp of their
sum), each with isolated vertices."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.graphs import csr as ref_csr  # noqa: E402
from repro_torch.core import bitset, greediris, imm, prng, rrr  # noqa: E402
from repro_torch.graphs import csr  # noqa: E402
from repro_torch.kernels import rrr_expand  # noqa: E402
from tests.test_torch_lt import GRAPHS, _graph, _push, _ref_step  # noqa: E402
from tests.test_torch_ref import (partitionable, port_graph,  # noqa: E402,F401
                                  port_key, to_port, u32, words)


def _crafted(kind: str):
    """A reference graph whose padded rows dip below their last sums
    (``dips``) or whose own sums fall (``falls``); vertices past the
    rows have no in-edge."""
    rng = np.random.default_rng(0)
    if kind == "dips":
        rows = [5000, 300, 400, 520, 700, 900, 1300, 2000, 2600]
        dst = np.repeat(np.arange(len(rows)), rows)
        return ref_csr.from_edge_list(rng.integers(0, 30, dst.size), dst, 30,
                                      seed=0)
    # a row of 1,065 weights, 30% of them below 1e-8 of the sum, beside a
    # hub of 1,500 and short rows
    m = int(rng.integers(300, 1200))
    w = np.where(rng.random(m) < 0.3, rng.random(m) * 1e-8,
                 rng.random(m)).astype(np.float32)
    w = (w / w.sum()).astype(np.float32)
    rows = [1500, m, 3, 40]
    n = len(rows) + 5
    other = [np.full(d, 1.0 / d, np.float32) for d in rows[2:]]
    weights = np.concatenate([np.full(1500, 1.0 / 1500, np.float32), w,
                              *other])
    indptr = np.concatenate([[0], np.cumsum(rows), np.full(5, sum(rows))])
    src = np.random.default_rng(1).integers(0, n, sum(rows))
    return ref_csr.CSRGraph(
        indptr=jnp.asarray(indptr, jnp.int32), indices=jnp.asarray(src,
                                                                   jnp.int32),
        probs=jnp.full(sum(rows), 0.05, jnp.float32),
        weights=jnp.asarray(weights))


def _ref_graph(kind: str):
    return _crafted(kind) if kind in ("dips", "falls") else _graph(kind)


KINDS = GRAPHS + ("dips", "falls")


def _ref_sums(g_ref):
    """The reference's padded rows: (cumulative weights [n, d] in XLA's
    order, in-degrees)."""
    nbr, _, wt = ref_csr.padded_adjacency(g_ref)
    return (np.asarray(jnp.cumsum(wt, axis=1)),
            np.asarray((np.asarray(nbr) >= 0).sum(1)))


@pytest.mark.parametrize("kind", KINDS)
def test_csr_tables_are_the_reference_rows_smallest_sums(kind):
    g_ref = _ref_graph(kind)
    cw, deg = _ref_sums(g_ref)
    lt = csr.lt_reverse(port_graph(g_ref))
    keep = np.arange(cw.shape[1])[None] < deg[:, None]
    np.testing.assert_array_equal(lt.cumw.numpy(),
                                  np.sort(cw, axis=1)[keep])
    np.testing.assert_array_equal(lt.indptr.numpy(), np.asarray(g_ref.indptr))
    np.testing.assert_array_equal(lt.src.numpy(), np.asarray(g_ref.indices))
    dips = [(deg[v] < cw.shape[1]) and cw[v, deg[v]:].min()
            < cw[v, :deg[v]].max() for v in range(len(deg)) if deg[v]]
    falls = [bool((np.diff(cw[v, :deg[v]]) < 0).any())
             for v in range(len(deg)) if deg[v]]
    if kind in ("dips", "falls"):
        assert any(dips if kind == "dips" else falls)
        assert (deg == 0).any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("extra", [0, 37, 4000])
def test_csr_tables_equal_the_padded_route(kind, extra):
    """``lt_reverse`` (no [n, d] tensor) equals ``rrr.lt_reverse_padded``
    (the padded sums sorted) at the largest in-degree and padded past
    it, where the tails hold other levels' sums."""
    g = port_graph(_ref_graph(kind))
    pad = g.max_in_degree() + extra
    want = rrr.lt_reverse_padded(*csr.padded_adjacency(g, pad)[::2])
    got = csr.lt_reverse(g, pad if extra else None)
    for a, b in zip((got.indptr, got.src, got.cumw),
                    (want.indptr, want.src, want.cumw)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_lt_reverse_refuses_a_pad_below_the_largest_row():
    g = port_graph(_graph("star"))
    with pytest.raises(ValueError, match="largest in-degree"):
        csr.lt_reverse(g, g.max_in_degree() - 1)


@pytest.mark.parametrize("kind", ["dips", "falls", "rmat"])
def test_each_draw_takes_the_reference_slot(kind):
    """Draws at every padded sum of the rows that dip or fall, and an
    ulp either side: the CSR search's slot and liveness are the
    reference's count over the whole padded row (``jnp.sum(r >=
    cumw)``, live below the in-degree)."""
    g_ref = _ref_graph(kind)
    cw, deg = _ref_sums(g_ref)
    lt = csr.lt_reverse(port_graph(g_ref))
    vs, rs = [], []
    for v in range(len(deg)):
        if not deg[v]:
            continue
        row = cw[v]
        odd = (row[deg[v]:].min(initial=np.inf) < row[:deg[v]].max()
               or (np.diff(row[:deg[v]]) < 0).any())
        if odd or kind == "rmat":
            vals = np.unique(row)
            vals = np.concatenate([vals, np.nextafter(vals, 0),
                                   np.nextafter(vals, 2)]).astype(np.float32)
            vs.append(np.full(vals.size, v))
            rs.append(vals)
    v, r = np.concatenate(vs), np.concatenate(rs)
    want = np.asarray(jnp.sum(jnp.asarray(r)[:, None]
                              >= jnp.asarray(cw[v]), axis=1))
    live = want < deg[v]
    chosen, ok = rrr_expand.lt_csr_slots(lt.indptr, lt.cumw,
                                         torch.from_numpy(v),
                                         torch.from_numpy(r))
    np.testing.assert_array_equal(ok.numpy(), live)
    np.testing.assert_array_equal(chosen.numpy()[live], want[live])
    assert live.any() and (~live).any()


@pytest.mark.parametrize("kind", ["dips", "falls"])
@pytest.mark.parametrize("w,density", [(1, 0.5), (4, 0.05)])
def test_push_matches_reference_step_on_odd_rows(kind, w, density):
    """The plain push and its wrapper on the CPU against the reference's
    packed LT step, on graphs with dipping or falling rows, a hub row
    and isolated vertices: planes word for word, the next list, the
    frontier read zeroed."""
    g_ref = _ref_graph(kind)
    n = g_ref.num_vertices
    rng = np.random.default_rng(n + w)
    f = words(rng, (n, w), density)
    vis = f | words(rng, (n, w), 0.1)
    jkey = jax.random.fold_in(jax.random.key(8), w)
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


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an operation returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def _padded(shapes, n: int, d: int) -> list:
    """The shapes of at least n x d elements with a row per vertex and
    d or more slots: a padded table."""
    return [s for s in shapes if len(s) >= 2 and s[0] == n and s[1] >= d]


@pytest.mark.parametrize("model", ["LT", "IC"])
def test_lt_kernel_path_builds_no_padded_table(model, monkeypatch):
    """``imm`` on the LT kernel path allocates no [n, d_max] tensor (and
    never calls ``padded_adjacency``); the IC push still reads its
    padded table, which the recorder sees."""
    g = port_graph(_crafted("dips"))
    n, d = g.num_vertices, g.max_in_degree()
    sel = imm.make_randgreedi_selector(4, use_kernel=True, solver="resident")
    if model == "LT":
        def refuse(*a, **k):
            raise AssertionError("the LT push built a padded table")
        monkeypatch.setattr(rrr, "padded_adjacency", refuse)
    with _Shapes() as rec:
        res = imm.imm(g, 3, 0.5, prng.key(5), model=model, max_theta=256,
                      selector=sel)
    assert res.theta > 0
    assert bool(_padded(rec.shapes, n, d)) == (model == "IC")


def test_round_and_sampler_take_the_csr_tables_alone():
    """The GreediRIS round and ``sample_incidence_host`` on the LT push,
    fed only ``lt`` (no padded table), equal the same runs fed the
    padded tables."""
    g = port_graph(_graph("rmat"))
    tables = rrr.graph_tables(g, "kernel", model="LT")
    assert tables[:4] == (None, None, None, None)
    kw = dict(m=4, n=g.num_vertices, theta=256, k=3, max_degree=0,
              model="LT", sampler="kernel", use_kernel=True, solver="lazy")
    fn, _, _ = greediris.build_round(lt=tables[4], **kw)
    got = fn(None, None, None, prng.key(3))
    padded = csr.padded_adjacency(g)
    fn, _, _ = greediris.build_round(**kw)
    want = fn(*padded, prng.key(3))
    assert got.seeds.tolist() == want.seeds.tolist()
    assert int(got.coverage) == int(want.coverage)
    x, theta = rrr.sample_incidence_host(g, 200, prng.key(4), model="LT",
                                         batch=64)
    y = torch.cat([rrr.sample_incidence(
        *padded, prng.key(4).fold_in(i), theta=b, n=g.num_vertices,
        model="LT") for i, b in enumerate((64, 64, 64, 32))], 1)
    assert theta == 224 and torch.equal(x, y)


@pytest.mark.parametrize("sampler,gather,model,padded", [
    ("kernel", "auto", "LT", False), ("kernel", "resident", "LT", False),
    ("kernel", "streamed", "LT", True), ("packed", "auto", "LT", True),
    ("dense", "auto", "LT", True), ("kernel", "auto", "IC", True)])
def test_reads_padded(sampler, gather, model, padded):
    assert rrr.reads_padded(sampler, gather, model) == padded


def test_the_lt_push_counts_bits_and_choice_reads():
    """``frontier_bits``, ``root_bits`` and ``choice_reads`` against a
    hand count over the dense entry point's steps: each step's live bits,
    and per vertex min(draws x (ceil(log2 deg) + 1), deg)."""
    g = port_graph(_graph("rmat"))
    lt = csr.lt_reverse(g)
    n = g.num_vertices
    roots = prng.key(2).randint((96,), 0, n, device="cpu")
    stats = {}
    got = rrr.rrr_batch_packed(None, None, None, None, None, roots,
                               prng.key(6), model="LT", max_steps=32,
                               expand="kernel", stats=stats, lt=lt)
    deg = (lt.indptr[1:] - lt.indptr[:-1]).tolist()
    per = [min(d, (d - 1).bit_length() + 1) if d else 0 for d in deg]
    visited = frontier = rrr.packed_roots(roots, n)
    key, bits, reads = prng.key(6), 0, 0
    for _ in range(stats["bfs_steps"]):
        per_v = bitset.popcount(frontier).sum(1).tolist()
        bits += sum(per_v)
        reads += sum(min(c * p, d) for c, p, d in zip(per_v, per, deg))
        key, sub = key.split()
        frontier, visited = rrr_expand.rrr_expand_step_lt(
            frontier, visited, lt.indptr, lt.src, lt.cumw, sub)
    assert torch.equal(visited, got)
    assert (stats["frontier_bits"], stats["choice_reads"],
            stats["root_bits"]) == (bits, reads, 96)
    assert bits > 96


@pytest.mark.parametrize("push", ["rrr_expand_push_lt", "rrr_expand_push_ic"])
def test_pushes_refuse_planes_of_2_31_words(push):
    """The pushes' int32 word lists: an [n, W] plane of 2^31 words is
    refused before anything is read (meta tensors: no memory)."""
    n, w = 1 << 16, 1 << 15
    meta = dict(device="meta", dtype=torch.int32)
    planes = [torch.empty((n, w), **meta) for _ in range(3)]
    lists = (torch.empty(n * w, **meta), torch.empty(1, **meta))
    words_ = torch.empty(4, **meta)
    if push == "rrr_expand_push_lt":
        args = (torch.empty(n + 1, **meta), torch.empty(8, **meta),
                torch.empty(8, device="meta"), prng.key(0))
    else:
        args = (torch.empty((n, 2), **meta),
                torch.empty((n, 32), device="meta"), [prng.key(0)], 32)
    with pytest.raises(ValueError, match="do not fit the int32 word list"):
        getattr(rrr_expand, push)(words_, *planes[:2], *args, planes[2],
                                  *lists)
    rrr_expand.refuse_wide(n, w // 2, push)     # below 2^31: taken
    rrr_expand.refuse_wide(1, 2**31 - 1, push)
