"""Kernels on the card against their plain versions (exact), and the
wrappers' refusals.  Needs an NVIDIA GPU and nvcc; skipped elsewhere.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import (bitset, cascade, greediris, imm,  # noqa: E402
                              maxcover, prng, rrr)
from repro_torch.graphs import csr, generators  # noqa: E402
from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.kernels import (bucket, bucket_insert, coins,  # noqa: E402
                                 coverage, greedy_pick, lazy_greedy, ops,
                                 rrr_expand, smem_budget, topk_gain)
from repro_torch.launch import serve  # noqa: E402
from tools import time_receiver  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _words(gen, *shape, dev):
    return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                         dtype=torch.int32).to(dev)


def _equal(got, want):
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n,df,w", [(37, 5, 3), (130, 3, 1), (8, 1, 40)])
def test_expand_layouts(dev, n, df, w):
    gen = torch.Generator().manual_seed(n)
    f = _words(gen, n, w, dev=dev) & _words(gen, n, w, dev=dev)
    vis = f | _words(gen, n, w, dev=dev)
    nbr = torch.randint(0, n, (n, df), generator=gen, dtype=torch.int32
                        ).to(dev)
    plane = _words(gen, 2 * n, w, dev=dev)
    gidx = torch.randint(0, 2 * n + 1, (n, df), generator=gen,
                         dtype=torch.int32).to(dev)
    _equal(rrr_expand.rrr_expand_step_resident(f, vis, nbr, gidx, plane),
           rrr_expand.expand_step_resident_plain(f, vis, nbr, gidx, plane))
    gm = _words(gen, n, df, w, dev=dev)
    _equal(rrr_expand.rrr_expand_step(f, vis, nbr, gm),
           rrr_expand.expand_step_plain(f, vis, nbr, gm))


def _expand_both(dev, step, plain, args, n, w, **opts):
    """Kernel and plain version of one plane step with the optional
    inputs ``opts`` (``slots``, ``lines``) and fresh ``next_lines`` and
    ``count``: the words, the emitted summary and count must be equal,
    and the summary and count those of the plain new frontier's lines.
    Returns the kernel's new frontier and visited."""
    out = []
    for fn in (step, plain):
        nl = torch.full((n, rrr_expand.num_lines(w)), 7, dtype=torch.uint8,
                        device=dev)
        cnt = torch.full((1,), -1, dtype=torch.int32, device=dev)
        out.append((*fn(*args, **opts, next_lines=nl, count=cnt), nl, cnt))
    _equal(out[0], out[1])
    want = rrr_expand.line_summary(out[1][0])
    assert torch.equal(out[0][2], want)
    assert int(out[0][3]) == int(want.sum())
    return out[0][:2]


def _plane_inputs(gen, n, df, w, kind, dev):
    """A plane step at width ``w``: a frontier (``sparse``: 1 line in 10
    live, bits thin; ``empty``; ``every line``: every word non-zero),
    visited, a plane and its random gidx, a gathered mask; valid slots
    first (``cnt`` of them) with other rows, gidx and mask words past
    them (``port``), and the same step with a random valid set, so
    sentinels stand mid-row, in the reference's form (``ref``)."""
    lines = rrr_expand.num_lines(w)
    f = _words(gen, n, w, dev=dev) & _words(gen, n, w, dev=dev)
    if kind == "sparse":
        f &= _words(gen, n, w, dev=dev)
        on = (torch.rand((n, lines), generator=gen) < 0.1).to(dev)
        f = torch.where(on.repeat_interleave(32, 1)[:, :w], f, 0)
    elif kind == "empty":
        f.zero_()
    else:
        f |= 1
    vis = _words(gen, n, w, dev=dev) & _words(gen, n, w, dev=dev)
    rows = 2 * n
    plane = _words(gen, rows, w, dev=dev)
    nbr = torch.randint(0, n, (n, df), generator=gen, dtype=torch.int32)
    gidx = torch.randint(0, rows, (n, df), generator=gen, dtype=torch.int32)
    gm = _words(gen, n, df, w, dev=dev)
    cnt = torch.randint(0, df + 1, (n,), generator=gen, dtype=torch.int32)
    valid = (torch.rand((n, df), generator=gen) < 0.6).to(dev)
    nbr, gidx = nbr.to(dev), gidx.to(dev)
    ref = (torch.where(valid, nbr, 0), torch.where(valid, gidx, rows),
           torch.where(valid[:, :, None], gm, 0))
    return f, vis, plane, (nbr, gidx, gm), ref, cnt.to(dev)


@pytest.mark.parametrize("w", [1, 2, 31, 32, 33, 1024])
@pytest.mark.parametrize("kind", ["sparse", "empty", "every line"])
def test_expand_options(dev, w, kind):
    """Both plane kernels with the optional inputs against their plain
    versions at every thread mapping (W = 1, 2: groups of lanes a row;
    31, 32, 33, 1024: a warp a line): a per-row count of valid-first
    slots (words past it never read), a summary with extra set bytes,
    no count with sentinels mid-row, no summary; the emitted summary and
    count against the plain new frontier's lines; an all-zero frontier
    and one with every line live."""
    gen = torch.Generator().manual_seed(w)
    n, df = (1500 if w < 1024 else 200), 6
    f, vis, plane, port, ref, cnt = _plane_inputs(gen, n, df, w, kind, dev)
    extra = (torch.rand((n, rrr_expand.num_lines(w)), generator=gen)
             < 0.2).to(dev)
    lines = rrr_expand.line_summary(f) | extra.to(torch.uint8)
    layouts = ((rrr_expand.rrr_expand_step_resident,
                rrr_expand.expand_step_resident_plain,
                lambda a: (a[0], a[1], plane)),
               (rrr_expand.rrr_expand_step, rrr_expand.expand_step_plain,
                lambda a: (a[0], a[2])))
    for step, plain, mask in layouts:
        want = plain(f, vis, *mask(ref))
        got = _expand_both(dev, step, plain, (f, vis, *mask(port)), n, w,
                           slots=cnt, lines=lines)
        assert kind != "sparse" or int((got[0] != 0).sum()) > 0
        # valid-first rows, read through the count: the step over the
        # same slots in the reference's form (every slot read)
        first = torch.arange(df, device=dev)[None] < cnt[:, None]
        clean = (torch.where(first, port[0], 0),
                 torch.where(first, port[1], 2 * n),
                 torch.where(first[:, :, None], port[2], 0))
        _equal(got, plain(f, vis, *mask(clean)))
        # no count: sentinels mid-row; with and without a summary
        _equal(_expand_both(dev, step, plain, (f, vis, *mask(ref)), n, w,
                            lines=rrr_expand.line_summary(f)), want)
        _equal(_expand_both(dev, step, plain, (f, vis, *mask(ref)), n, w),
               want)


@pytest.mark.parametrize("w", [2, 33, 64])
def test_expand_options_hub_rows(dev, w):
    """The plane kernels on an rmat graph's forward table (hub rows of
    more than 32 slots, read in chunks of 32) as the sampler's streamed
    layout feeds them: the count ``t.slots``, the roots' summary, the
    plane gathered through ``t.take`` (row 0 past each row's valid
    slots), against the plain step over the zeroed gather."""
    gen = torch.Generator().manual_seed(11)
    g = generators.rmat(12, 1 << 15, seed=3, device=dev)
    nbr, prob, wt = csr.padded_adjacency(g)
    t = rrr._Tables(nbr, prob, wt, *csr.padded_forward_adjacency(g),
                    model="IC", coin_chunk=32)
    n = t.n
    assert t.nbr_c.shape[1] > 32
    roots = torch.randint(0, n, (32 * w,), generator=gen).to(dev)
    f = rrr.packed_roots(roots, n)
    vis = f | (_words(gen, n, w, dev=dev) & _words(gen, n, w, dev=dev))
    plane = _words(gen, n * t.d_pad, w, dev=dev)
    gm = plane.index_select(0, t.take).view(n, -1, w)
    zeroed = torch.where(t.valid[:, :, None], gm, 0)
    want = rrr_expand.expand_step_plain(f, vis, t.nbr_c, zeroed)
    lines = rrr.root_lines(roots, n, w)
    got = _expand_both(dev, rrr_expand.rrr_expand_step,
                       rrr_expand.expand_step_plain, (f, vis, t.nbr_c, gm),
                       n, w, slots=t.slots, lines=lines)
    _equal(got, want)
    assert int((got[0] != 0).sum()) > 0
    got = _expand_both(dev, rrr_expand.rrr_expand_step_resident,
                       rrr_expand.expand_step_resident_plain,
                       (f, vis, t.nbr_c, t.gidx, plane), n, w,
                       slots=t.slots, lines=lines)
    _equal(got, want)


def test_expand_options_refused_on_another_device(dev):
    f = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    nbr = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    for opts in (dict(slots=torch.zeros(4, dtype=torch.int32)),
                 dict(lines=torch.zeros((4, 1), dtype=torch.uint8)),
                 dict(count=torch.zeros(1, dtype=torch.int32))):
        with pytest.raises(ValueError, match="several devices"):
            rrr_expand.rrr_expand_step(f, f, nbr, f[:, None], **opts)
        with pytest.raises(ValueError, match="several devices"):
            rrr_expand.rrr_expand_step_resident(f, f, nbr, nbr, f, **opts)


@pytest.mark.parametrize("n,w,chunk,n_chunks,frontier", [
    (50, 4, 2, 3, "random"),
    (50, 1, 2, 3, "random"),          # one word a row: 4-byte path
    (50, 3, 4, 2, "random"),          # W < 4
    (70, 33, 3, 2, "random"),         # 8 chunks of four words and a tail
    (40, 8, 2, 3, "full"),            # every bit set: every coin hashed
    (40, 8, 4, 2, "empty"),           # nothing set: an all-zero plane
    (50, 4, 2, 3, "unaligned"),       # a frontier 4 bytes off 16
    (2**17, 80, 16, 1, "sparse"),     # draw indices past 2^32 (0.67 GB)
])
def test_coin_plane(dev, n, w, chunk, n_chunks, frontier):
    """The coin plane equals its plain version word for word, zeros
    included: every W path, several chunk keys, a fifth of the slots at
    p = 0, and a shape whose high words draw indices above 2^32."""
    gen = torch.Generator().manual_seed(n + w)
    keys = [prng.key(3).fold_in(c) for c in range(n_chunks)]
    prob = torch.rand((n, chunk * n_chunks), generator=gen) * 0.7
    prob[torch.rand(prob.shape, generator=gen) < 0.2] = 0.0
    prob = prob.to(dev)
    words = _words(gen, n * w + 1, dev=dev)
    if frontier == "full":
        words[:] = -1
    elif frontier == "empty":
        words[:] = 0
    elif frontier == "sparse":                 # a set bit in ~1% of words
        words &= _words(gen, n * w + 1, dev=dev) & _words(
            gen, n * w + 1, dev=dev)
        words = torch.where(torch.rand(n * w + 1, generator=gen).to(dev)
                            < 0.01, words, 0)
    f = (words[1:] if frontier == "unaligned" else words[:-1]).view(n, w)
    if frontier == "sparse":
        assert 32 * 64 * n * chunk == 2**32 and bool((f[:, 64:] != 0).any())
    _equal([coins.coin_plane(keys, prob, f, chunk)],
           [coins.coin_plane_plain(keys, prob, f, chunk)])


def _ic_graph(gen, n, df, d, w, chunk, dens, dev):
    """An IC step's inputs from a random reverse table: in-degrees
    Poisson(df) cut at d (vertex 0 at d), -1 after each row's valid
    slots, a fifth of the probabilities zero (the padded slots too), a
    frontier of density 2^-dens with a tenth of its words all ones, and
    visited a superset of it; with the pull's forward tables (nbr_c,
    gidx) from rrr._Tables."""
    deg = torch.poisson(torch.full((n,), float(df)), generator=gen
                        ).long().clamp(max=d)
    deg[0] = d
    src = torch.randint(0, n, (n, d), generator=gen)
    dst = torch.arange(n)[:, None].expand(n, d)
    keep = torch.arange(d)[None] < deg[:, None]
    probs = torch.rand(int(keep.sum()), generator=gen) * 0.6
    probs[torch.rand(probs.shape[0], generator=gen) < 0.2] = 0.0
    g = csr.from_edge_list(src[keep].numpy(), dst[keep].numpy(), n,
                           probs=probs.numpy(), device=dev)
    return _graph_step(gen, g, w, chunk, dens, dev)


def _graph_step(gen, g, w, chunk, dens, dev):
    n = g.num_vertices
    nbr, prob, wt = csr.padded_adjacency(g)
    t = rrr._Tables(nbr, prob, wt, *csr.padded_forward_adjacency(g),
                    model="IC", coin_chunk=chunk)
    f = _words(gen, n, w, dev=dev)
    for _ in range(dens):
        f &= _words(gen, n, w, dev=dev)
    f[(torch.rand((n, w), generator=gen) < 0.1).to(dev)] = -1
    vis = f | (_words(gen, n, w, dev=dev) & _words(gen, n, w, dev=dev))
    keys = [prng.key(5).fold_in(c) for c in range(t.n_chunks)]
    return t, f, vis, keys


def _push_both(t, f, vis, keys):
    """The push kernel and its plain version on copies of one step:
    (next plane, visited, sorted next list, frontier after) of each."""
    n, w = f.shape
    words = rrr_expand.live_words(f)
    outs = []
    for fn in (rrr_expand.rrr_expand_push_ic,
               rrr_expand.expand_step_ic_push_plain):
        fc, vc, nxt = f.clone(), vis.clone(), torch.zeros_like(f)
        listed = torch.empty(n * w, dtype=torch.int32, device=f.device)
        count = torch.zeros(1, dtype=torch.int32, device=f.device)
        fn(words, fc, vc, t.nbr, t.prob_p, keys, t.chunk, nxt, listed,
           count)
        outs.append((nxt, vc, listed[:int(count)].sort().values, fc))
    return outs


@pytest.mark.parametrize("n,df,d,w,chunk,dens", [
    (1001, 3, 5, 1, 3, 1), (301, 4, 11, 5, 4, 0), (4093, 4, 16, 33, 16, 2),
    (262144, 2, 16, 40, 16, 4)])     # the last draw index passes 2**32
def test_expand_ic(dev, n, df, d, w, chunk, dens):
    """The push kernel against its plain version (planes word for word,
    lists as sorted sets, the frontier it read zeroed), and the dense
    entry point against the pull's plain version and the composed coin
    plane + resident expansion: all-ones frontier words, invalid slots
    and p = 0 slots, 1-3 chunks."""
    gen = torch.Generator().manual_seed(n + w)
    t, f, vis, keys = _ic_graph(gen, n, df, d, w, chunk, dens, dev)
    kernel, plain = _push_both(t, f, vis, keys)
    _equal(kernel, plain)
    assert not bool(kernel[3].any())
    assert kernel[2].unique().numel() == kernel[2].numel()
    got = rrr_expand.rrr_expand_step_ic(f, vis, t.nbr, t.prob_p, keys,
                                        t.chunk)
    _equal(got, kernel[:2])
    _equal(got, rrr_expand.expand_step_ic_plain(
        f, vis, t.nbr_c, t.gidx, t.prob_p, keys, t.chunk))
    plane = coins.coin_plane(keys, t.prob_p, f, t.chunk).reshape(-1, w)
    _equal(got, rrr_expand.rrr_expand_step_resident(f, vis, t.nbr_c, t.gidx,
                                                    plane))
    assert int((got[0] != 0).sum()) > 0


@pytest.mark.parametrize("graph", ["star", "reverse star", "rmat"])
def test_push_ic_hubs(dev, graph):
    """The push kernel against its plain version where rows are skewed:
    a star (every leaf pushes into the hub's words, p = 1), a reverse
    star (one reverse row of 4,999 slots) and an rmat graph's first
    sampler step (hub rows and hub targets)."""
    gen = torch.Generator().manual_seed(7)
    if graph == "star":
        g = generators.star(5000, device=dev)
    elif graph == "reverse star":
        g = csr.from_edge_list(np.arange(1, 5000), np.zeros(4999, np.int64),
                               5000, seed=2, device=dev)
    else:
        g = generators.rmat(14, 1 << 16, seed=3, device=dev)
    t, f, vis, keys = _graph_step(gen, g, 7, 32, 3, dev)
    if graph == "rmat":
        f = rrr.packed_roots(torch.randint(0, g.num_vertices, (7 * 32,),
                                           generator=gen).to(dev),
                             g.num_vertices)
        vis = f.clone()
    kernel, plain = _push_both(t, f, vis, keys)
    _equal(kernel, plain)
    assert int((kernel[0] != 0).sum()) > 0


def _cascade_inputs(gen, g, num_sims, coin_chunk, dev):
    """A cascade step on graph ``g``: its reverse table, a frontier with
    every word non-zero (pad lanes too), a sparse visited plane and the
    key table."""
    nbr, prob, _ = csr.padded_adjacency(g)
    chunk, n_chunks, _ = rrr._coin_chunks(nbr.shape[1], coin_chunk)
    n, w = g.num_vertices, (num_sims + 31) // 32
    f = _words(gen, n, w, dev=dev) | 1
    vis = _words(gen, n, w, dev=dev) & _words(gen, n, w, dev=dev)
    keys = rrr_expand.cascade_keys(prng.key(9), n_chunks, num_sims, dev)
    return nbr, prob, chunk, f, vis, keys


@pytest.mark.parametrize("graph,num_sims,coin_chunk", [
    ("er", 64, 32), ("er", 100, 3), ("er", 1, 32), ("reverse star", 64, 32),
    ("reverse star", 33, 7)])
def test_cascade_ic(dev, graph, num_sims, coin_chunk):
    """cascade_ic against its plain version for every lane group width,
    with its count of new words: dense frontiers, pad lanes, several
    chunks, and a hub row of 1,999 slots."""
    gen = torch.Generator().manual_seed(num_sims)
    if graph == "er":
        g = generators.erdos_renyi(3000, 6.0, seed=4, device=dev)
    else:
        g = csr.from_edge_list(np.arange(1, 2000), np.zeros(1999, np.int64),
                               2000, seed=2, device=dev)
    nbr, prob, chunk, f, vis, keys = _cascade_inputs(gen, g, num_sims,
                                                     coin_chunk, dev)
    want = rrr_expand.cascade_step_ic_plain(f, vis, nbr, prob, keys, chunk,
                                            num_sims)
    assert int((want[0] != 0).sum()) > 0
    for lanes in (1, 2, 4, 8, 16, 32):
        count = torch.full((1,), 7, dtype=torch.int32, device=dev)
        got = rrr_expand.cascade_step_ic(f, vis, nbr, prob, keys, chunk,
                                         num_sims, count=count, lanes=lanes)
        _equal(got, want)
        assert int(count) == int((want[0] != 0).sum())


def test_cascade_ic_route_on_card(dev):
    """The IC kernel route launches cascade_ic and no plane kernel, and
    its words equal the plane routes' on the card and the CPU's."""
    seeds = torch.tensor([0, 5, 77, -1, 4000])
    words = {}
    for device in (dev, "cpu"):
        g = generators.erdos_renyi(3000, 4.0, seed=5, device=device)
        for gather in ("auto", "resident", "streamed"):
            ops.reset_launches()
            words[(str(device), gather)] = cascade.simulate_cascades(
                g, seeds, prng.key(2), gather=gather).cpu()
            if device == dev and gather == "auto":
                assert ops.LAUNCHES["cascade_ic"] > 0
                assert not ops.LAUNCHES["rrr_expand_streamed"]
                assert not ops.LAUNCHES["rrr_expand_resident"]
    first = words[(str(dev), "auto")]
    assert int((first != 0).sum()) > 5
    assert all(torch.equal(first, w) for w in words.values())


def _lt_graph(graph, dev):
    if graph == "er":
        return generators.erdos_renyi(3000, 4.0, seed=4, device=dev)
    if graph == "star":
        return generators.star(5000, device=dev)
    if graph in ("reverse star", "unsorted rows"):
        return csr.from_edge_list(np.arange(1, 2000), np.zeros(1999, np.int64),
                                  2000, seed=2, device=dev)
    if graph == "rmat":
        return generators.rmat(14, 1 << 16, seed=3, device=dev)
    if graph == "dips":         # padded tails an ulp below their rows' sums
        rng = np.random.default_rng(0)
        rows = [5000, 300, 400, 520, 700, 900, 1300, 2000, 2600]
        dst = np.repeat(np.arange(len(rows)), rows)
        return csr.from_edge_list(rng.integers(0, 30, dst.size), dst, 30,
                                  seed=0, device=dev)
    return generators.erdos_renyi(262144, 4.0, seed=0, device=dev)


def _lt_sampler_tables(gen, graph, dev):
    """LT tables on ``graph``: the padded ones of the plane routes and
    the cascade (``t.cumw``, ``t.lt_rows``; "unsorted rows" permutes each
    row's cumulative weights, so the hub row is marked and searched
    whole) and the push's CSR tables (``t.lt``)."""
    g = _lt_graph(graph, dev)
    nbr, prob, wt = csr.padded_adjacency(g)
    t = rrr._Tables(nbr, prob, wt, *csr.padded_forward_adjacency(g),
                    model="LT", coin_chunk=32)
    t.lt = csr.lt_reverse(g)
    if graph == "unsorted rows":
        t.cumw, t.lt_rows = rrr_expand.lt_tables(t.nbr, t.cumw[
            :, torch.randperm(t.d, generator=gen).to(dev)])
        assert int((t.lt_rows < 0).sum()) > 0
    return t


def _lt_push_both(t, f, vis, key):
    n, w = f.shape
    words = rrr_expand.live_words(f)
    outs = []
    for fn in (rrr_expand.rrr_expand_push_lt,
               rrr_expand.expand_step_lt_push_plain):
        fc, vc, nxt = f.clone(), vis.clone(), torch.zeros_like(f)
        listed = torch.empty(n * w, dtype=torch.int32, device=f.device)
        count = torch.zeros(1, dtype=torch.int32, device=f.device)
        fn(words, fc, vc, t.lt.indptr, t.lt.src, t.lt.cumw, key, nxt, listed,
           count)
        outs.append((nxt, vc, listed[:int(count)].sort().values, fc))
    return outs


@pytest.mark.parametrize("graph,w", [
    ("er", 3), ("er", 1), ("star", 7), ("reverse star", 7), ("rmat", 7),
    ("unsorted rows", 7), ("dips", 7),
    ("imm", 520)])   # imm: the draw index passes 2**32
def test_expand_lt(dev, graph, w):
    """rrr_expand_lt against its plain version (planes word for word,
    lists as sorted sets, each word listed once, the frontier it read
    zeroed), and the dense entry point against the selection plane
    through the resident expansion: short rows and hub rows binary
    searched (reverse star, rmat), a marked row searched whole, a star
    whose leaves all push into the hub, and the IMM graph's roots at
    W = 520, where s * n + v passes 2**32."""
    gen = torch.Generator().manual_seed(w)
    t = _lt_sampler_tables(gen, graph, dev)
    n = t.n
    if graph == "imm":
        f = rrr.packed_roots(torch.randint(0, n, (32 * w,), generator=gen
                                           ).to(dev), n)
        vis = f.clone()
    else:
        f = _words(gen, n, w, dev=dev) & _words(gen, n, w, dev=dev)
        vis = f | (_words(gen, n, w, dev=dev) & _words(gen, n, w, dev=dev))
    key = prng.key(13).fold_in(w)
    kernel, plain = _lt_push_both(t, f, vis, key)
    _equal(kernel, plain)
    assert not bool(kernel[3].any())
    assert kernel[2].unique().numel() == kernel[2].numel()
    assert int((kernel[0] != 0).sum()) > 0
    got = rrr_expand.rrr_expand_step_lt(f, vis, t.lt.indptr, t.lt.src,
                                        t.lt.cumw, key)
    _equal(got, kernel[:2])
    if graph != "unsorted rows":
        plane = rrr._lt_mask(t, key, f).reshape(n * t.d_pad, -1)
        _equal(got, rrr_expand.rrr_expand_step_resident(f, vis, t.nbr_c,
                                                        t.gidx, plane))


def test_expand_lt_empty_list(dev):
    """An empty word list launches nothing and lists nothing."""
    lt = csr.lt_reverse(_lt_graph("er", dev))
    n = lt.num_vertices
    f = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    listed = torch.empty(n * 2, dtype=torch.int32, device=dev)
    count = torch.full((1,), 9, dtype=torch.int32, device=dev)
    ops.reset_launches()
    rrr_expand.rrr_expand_push_lt(
        torch.zeros(0, dtype=torch.int32, device=dev), f, f.clone(),
        lt.indptr, lt.src, lt.cumw, prng.key(1), f.clone(), listed, count)
    assert int(count) == 0 and ops.LAUNCHES["rrr_expand_lt"] == 0


@pytest.mark.parametrize("graph,num_sims", [
    ("er", 64), ("er", 100), ("er", 1), ("reverse star", 64),
    ("reverse star", 33), ("rmat", 64), ("unsorted rows", 64)])
def test_cascade_lt(dev, graph, num_sims):
    """cascade_lt against its plain version for every lane group width,
    with its count of new words: dense frontiers, pad lanes, hub rows
    searched and a marked row searched whole."""
    gen = torch.Generator().manual_seed(num_sims)
    t = _lt_sampler_tables(gen, graph, dev)
    n, w = t.n, bitset.num_words(num_sims)
    f = _words(gen, n, w, dev=dev) | 1
    vis = _words(gen, n, w, dev=dev) & _words(gen, n, w, dev=dev)
    keys = rrr_expand.lt_cascade_keys(prng.key(9), num_sims, dev)
    want = rrr_expand.cascade_step_lt_plain(f, vis, t.nbr, t.cumw, t.lt_rows,
                                            keys, num_sims)
    assert int((want[0] != 0).sum()) > 0
    for lanes in (1, 2, 4, 8, 16, 32):
        count = torch.full((1,), 7, dtype=torch.int32, device=dev)
        got = rrr_expand.cascade_step_lt(f, vis, t.nbr, t.cumw, t.lt_rows,
                                         keys, num_sims, count=count,
                                         lanes=lanes)
        _equal(got, want)
        assert int(count) == int((want[0] != 0).sum())


def test_lt_routes_on_card(dev):
    """LT sampling on the resident layout launches rrr_expand_lt and no
    plane kernel, the LT spread's kernel route cascade_lt and no plane
    kernel; both equal the plane routes and the CPU."""
    seeds = torch.tensor([0, 5, 77, -1, 4000])
    words, x = {}, {}
    for device in (dev, "cpu"):
        g = generators.erdos_renyi(3000, 4.0, seed=5, device=device)
        nbr, prob, wt = csr.padded_adjacency(g)
        fwd = csr.padded_forward_adjacency(g)
        for gather in ("auto", "streamed"):
            ops.reset_launches()
            x[(str(device), gather)] = rrr.sample_incidence(
                nbr, prob, wt, prng.key(4), theta=256, n=3000, model="LT",
                fwd=fwd, gather=gather).cpu()
            if device == dev and gather == "auto":
                assert ops.LAUNCHES["rrr_expand_lt"] > 0
                assert not ops.LAUNCHES["rrr_expand_resident"]
                assert not ops.LAUNCHES["rrr_expand_streamed"]
        for gather in ("auto", "resident", "streamed"):
            ops.reset_launches()
            words[(str(device), gather)] = cascade.simulate_cascades(
                g, seeds, prng.key(2), model="LT", gather=gather).cpu()
            if device == dev and gather == "auto":
                assert ops.LAUNCHES["cascade_lt"] > 0
                assert not ops.LAUNCHES["rrr_expand_streamed"]
                assert not ops.LAUNCHES["rrr_expand_resident"]
    first = x[(str(dev), "auto")]
    assert all(torch.equal(first, v) for v in x.values())
    first = words[(str(dev), "auto")]
    assert int((first != 0).sum()) > 5
    assert all(torch.equal(first, v) for v in words.values())


@pytest.mark.parametrize("model", ["IC", "LT", "WC"])
def test_engines_on_card(dev, model):
    """Every engine and gather of the spread gives the CPU's words on the
    card; WC's kernel route launches cascade_ic (its probabilities the LT
    weights) and no plane kernel; map and packed launch nothing."""
    seeds = torch.tensor([0, 5, 77, -1, 4000])
    want = cascade.simulate_cascades(
        generators.erdos_renyi(3000, 4.0, seed=5, device="cpu"), seeds,
        prng.key(2), model=model, engine="map")
    g = generators.erdos_renyi(3000, 4.0, seed=5, device=dev)
    for engine, gather in (("kernel", "auto"), ("kernel", "resident"),
                           ("kernel", "streamed"), ("packed", "auto"),
                           ("map", "auto")):
        ops.reset_launches()
        got = cascade.simulate_cascades(g, seeds, prng.key(2), model=model,
                                        engine=engine, gather=gather)
        assert torch.equal(got.cpu(), want)
        if engine != "kernel":
            assert not any(ops.LAUNCHES.values())
        elif gather == "auto":
            assert ops.LAUNCHES["cascade_lt" if model == "LT"
                                else "cascade_ic"] > 0
            assert not ops.LAUNCHES["rrr_expand_streamed"]
            assert not ops.LAUNCHES["rrr_expand_resident"]
    assert int((want != 0).sum()) > 5


def test_faulted_round_on_card(dev):
    """The resilient round on the card, lazy senders: the survivors and
    the seeds of the CPU's round and of the direct survivors merge."""
    from repro_torch.core import randgreedi
    from repro_torch.runtime import faults
    g = generators.erdos_renyi(3000, 4.0, seed=5, device=dev)
    nbr, prob, wt = csr.padded_adjacency(g)
    rows = rrr.sample_incidence(nbr, prob, wt, prng.key(1), theta=1024,
                                n=3000, model="IC",
                                fwd=csr.padded_forward_adjacency(g))
    plan = [("local.greedy", "drop", 1), ("local.greedy", "nan", 2),
            ("receiver.insert", "raise", 0)]
    out = {}
    for rows_on, solver in ((rows, "lazy"), (rows.cpu(), "scan")):
        ops.reset_launches()
        res, surv, alpha = faults.resilient_randgreedi(
            rows_on, prng.key(2), m=4, k=10, solver=solver,
            plan=faults.FaultPlan([faults.FaultSpec(*p) for p in plan]))
        if solver == "lazy":
            assert ops.LAUNCHES["lazy_greedy_compact"] + \
                ops.LAUNCHES["lazy_greedy"] > 0
        out[solver] = (res.seeds.cpu().tolist(), int(res.coverage), surv,
                       alpha)
    clean = randgreedi.randgreedi_maxcover(rows, prng.key(2), m=4, k=10,
                                           survivors=(0, 3))
    assert out["lazy"] == out["scan"]
    assert out["lazy"][:3] == (clean.seeds.cpu().tolist(),
                               int(clean.coverage), (0, 3))


def test_greedy_and_bucket(dev):
    gen = torch.Generator().manual_seed(2)
    rows = _words(gen, 4, 300, 3, dev=dev) & _words(gen, 4, 300, 3, dev=dev)
    ex = torch.tensor([[1, -1], [0, 299], [-1, -1], [7, 8]],
                      dtype=torch.int32, device=dev)
    _equal(greedy_pick.greedy_maxcover_resident(rows, 9, ex),
           greedy_pick.greedy_plain(rows, 9, ex))
    args = (torch.arange(-1, 40, dtype=torch.int32, device=dev),
            _words(gen, 41, 3, dev=dev), _words(gen, 9, 3, dev=dev),
            torch.tensor([0, 1, 2, 3, 0, 1, 2, 3, 3], dtype=torch.int32,
                         device=dev),
            torch.full((9, 3), -1, dtype=torch.int32, device=dev),
            torch.rand(9, generator=gen).to(dev) * 30)
    _equal(bucket_insert.bucket_insert_chunk(*args),
           bucket_insert.bucket_insert_plain(*args))


def test_gain_sweeps_and_lazy_solve(dev):
    gen = torch.Generator().manual_seed(3)
    rows = _words(gen, 3, 301, 5, dev=dev) & _words(gen, 3, 301, 5, dev=dev)
    rows[:, 40] = rows[:, 7]                     # a tie across two tiles
    cov = _words(gen, 3, 5, dev=dev) & _words(gen, 3, 5, dev=dev)
    picked = (torch.rand((3, 301), generator=gen) < 0.3).to(dev)
    picked[2] = True                             # every row picked
    _equal([coverage.marginal_gain(rows, cov)],
           [coverage.marginal_gain_plain(rows, cov)])
    _equal(topk_gain.best_gain_index(rows, cov, picked),
           topk_gain.best_gain_index_plain(rows, cov, picked))
    ex = torch.tensor([[1, -1], [0, 300], [-1, -1]], dtype=torch.int32,
                      device=dev)
    *got, swept = lazy_greedy.greedy_maxcover_lazy(rows, 12, ex)
    *want, _ = lazy_greedy.lazy_plain(rows, 12, ex)
    _equal(got, want)
    tiles = lazy_greedy.num_row_tiles(301)
    assert all(tiles <= int(t) <= 12 * tiles for t in swept)
    assert 1 <= lazy_greedy.blocks_per_machine(3, 301, 5, dev) <= tiles


def _machine_rows(gen, case, dev):
    """Machine-axis rows [3, 1000, W] with a tie across two tiles: about
    25% of the bits set ("dense"), or about 1% of the words non-zero
    ("sparse"; W = 5 for 4-byte loads in "unaligned"; every 97th row all
    non-zero, longer than a lane sums alone, in "heavy")."""
    w = 5 if case == "unaligned" else 36
    rows = _words(gen, 3, 1000, w, dev=dev) & _words(gen, 3, 1000, w, dev=dev)
    if case != "dense":
        keep = (torch.rand((3, 1000, w), generator=gen) < 0.01).to(dev)
        if case == "heavy":
            keep[:, ::97] = True
        rows = torch.where(keep, rows, 0)
    rows[:, 40] = rows[:, 7]
    return rows


@pytest.mark.parametrize("case", ["sparse", "dense", "unaligned", "heavy"])
def test_machine_axis_layouts(dev, case):
    """The machine-axis solves take the compact layout on sparse rows and
    the dense sweep on dense rows, say so in ``stats`` and in the launch
    counts, and equal their plain versions either way (the forced other
    layout too); tiles_swept stays in range.  On the dense layout the
    dense kernel runs, then, when ``stats`` reports a handover, one more
    compaction (of the residual) and the compact picks."""
    gen = torch.Generator().manual_seed(11)
    rows = _machine_rows(gen, case, dev)
    ex = torch.tensor([[7, -1], [3, 999], [-1, -1]], dtype=torch.int32,
                      device=dev)
    k, tiles = 20, lazy_greedy.num_row_tiles(1000)
    layout = "dense" if case == "dense" else "compact"
    want = greedy_pick.greedy_plain(rows, k, ex)
    lists = greedy_pick.compact_rows_plain(rows)
    for fn, name in ((greedy_pick.greedy_maxcover_resident, "greedy_pick"),
                     (lazy_greedy.greedy_maxcover_lazy, "lazy_greedy")):
        ops.reset_launches()
        stats = {}
        got = fn(rows, k, ex, stats=stats)
        assert stats["layout"] == layout
        assert stats["nonzero_words"] == lists.nonzero_words
        assert stats["listed_rows"] == int(lists.listed.sum())
        _equal(got[:4], want)
        if layout == "dense":
            handed = int(stats["handover_pick"] is not None)
            launched = {"compact_rows": 1 + handed, name: 1,
                        name + "_compact": handed}
        else:
            launched = {"compact_rows": 1, name + "_compact": 1}
        assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
            k: v for k, v in launched.items() if v}
        assert ops.HANDOVERS[name] == launched.get(name + "_compact", 0) * (
            layout == "dense")
        if name == "lazy_greedy":
            assert all(tiles <= int(t) <= k * tiles for t in got[4])
    full = greedy_pick.compact_rows(rows, rows.numel())
    lists = full._replace(entries=full.entries[:full.nonzero_words])
    _equal(greedy_pick.greedy_compact(rows, k, ex, lists), want)
    *got, swept = lazy_greedy.lazy_compact(rows, k, ex, lists)
    _equal(got, want)
    assert all(tiles <= int(t) <= k * tiles for t in swept)
    _equal(greedy_pick.greedy_dense(rows, k, ex), want)
    _equal(lazy_greedy.lazy_dense(rows, k, ex)[:4], want)


def _dense_case(case, dev):
    """The CPU tests' dense machine rows (``test_torch_maxcover.py``
    ``dense_case``: every word non-zero, exclusions, gains that run out
    before k or last past it, or on one machine many picks before the
    other's), made here with numpy from the same seed, and a wider set of
    the same kind (m = 4, 300 rows of 36 words)."""
    m, n, w, k = (2, 40, 2, 4 if case == "lasts" else 24) if case in (
        "exhausts", "lasts", "uneven") else (4, 300, 36, 100)
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 2**32, (m, n, w), dtype=np.uint32)
    for _ in range(2):
        rows &= rng.integers(0, 2**32, (m, n, w), dtype=np.uint32)
    rows |= np.uint32(1) << rng.integers(0, 32, (m, n, w)).astype(np.uint32)
    rows[:, 9] = rows[:, 4]
    if case == "uneven":
        rows[1, 3:] = 0
    ex = np.full((m, 3), -1, np.int32)
    ex[0, :2], ex[1] = (4, 17), (0, n + 3, 22)
    return (torch.from_numpy(rows.view(np.int32)).to(dev), k,
            torch.from_numpy(ex).to(dev))


@pytest.mark.parametrize("case", ["exhausts", "lasts", "uneven", "wide"])
@pytest.mark.parametrize("after", [0, 1, 2, "k - 1", "never"])
def test_dense_handover(dev, case, after):
    """Both dense kernels with the handover forced after pick 0, 1, 2 or
    k - 1 (``cap`` the residual the kernel counted there) or never: the
    whole solve equals the plain one; ``greedy_pick`` counts the residual
    exactly (as its plain version) and stops where the gains ran out, as
    its plain version; ``lazy_greedy``'s counts bound the exact ones and
    hand over at the first pick at most ``cap``.  From the handover
    state, the masked compaction equals its plain version (as sets per
    row) and each compact kernel equals its plain version from the same
    state, its stop where the gains run out included."""
    rows, k, ex = _dense_case(case, dev)
    m, n, _ = rows.shape
    want = greedy_pick.greedy_plain(rows, k, ex)
    exact = greedy_pick.greedy_dense_plain(rows, k, ex)
    tiles = lazy_greedy.num_row_tiles(n)
    for name, dense in (("greedy_pick", greedy_pick.greedy_dense),
                        ("lazy_greedy", lazy_greedy.lazy_dense)):
        full = {}
        got = dense(rows, k, ex, cap=0, stats=full)
        _equal(got[:4], want)
        residual = full["residual"]
        assert full["handover_pick"] is None
        assert full["spent_pick"] == (exact.p0 if exact.spent else None)
        if name == "greedy_pick":
            assert residual == exact.residual
        else:
            assert len(residual) == len(exact.residual) and all(
                a >= b for a, b in zip(residual, exact.residual))
        if after == "never":
            continue
        p = min(k - 1 if after == "k - 1" else after, len(residual) - 1)
        cap = residual[p]
        stats = {}
        got = dense(rows, k, ex, cap=cap, stats=stats)
        _equal(got[:4], want)
        if name == "greedy_pick":
            first = next(i for i, r in enumerate(residual) if r <= cap)
            assert stats["handover_pick"] == (first + 1 if first + 1 < k
                                              else None)
        else:
            assert stats["handover_pick"] is None or (
                stats["handover_pick"] <= p + 1)
            assert all(tiles <= int(t) <= k * tiles for t in got[4])
    # the handover state of the plain dense picks, on the card
    cap = exact.residual[min(2, len(exact.residual) - 1)]
    state = greedy_pick.greedy_dense_plain(rows, k, ex, cap)
    state = state._replace(taken=state.taken.to(torch.uint8))
    lists = greedy_pick.residual_lists(rows, state, cap)
    plain_lists = greedy_pick.compact_rows_plain(rows, state.out[2],
                                                 state.taken)
    _equal(greedy_pick.canonical_lists(lists),
           greedy_pick.canonical_lists(plain_lists))

    def clone(s):
        return s._replace(out=tuple(o.clone() for o in s.out),
                          taken=s.taken.clone())
    _equal(greedy_pick.greedy_compact(rows, k, ex, lists, clone(state)),
           greedy_pick.greedy_compact_plain(rows, k, ex, lists,
                                            clone(state)))
    _equal(greedy_pick.greedy_compact(rows, k, ex, lists, clone(state)), want)
    ub, swept = lazy_greedy.fresh_bounds(m, n, dev)
    got = lazy_greedy.lazy_compact(rows, k, ex, lists, clone(state),
                                   ub.clone(), swept.clone())
    _equal(got[:4], want)
    _equal(got[:4], lazy_greedy.lazy_compact_plain(
        rows, k, ex, lists, clone(state), ub.clone(), swept.clone())[:4])
    assert all(0 <= int(t) <= k * tiles for t in got[4])


@pytest.mark.parametrize("m,n,w,share", [(3, 1000, 36, 0.01),
                                         (2, 777, 5, 0.05),
                                         (1, 4096, 1024, 0.03)])
def test_compact_rows_lists_every_nonzero_word(dev, m, n, w, share):
    """The compaction kernel lists the rows and words of the plain
    version (as sets per row; the tile table holds each slot in its
    row's tile); an allocation it outgrows counts every word, and the
    wrapper's one launch leaves a list longer than the compact layout
    pays for unwritten (the last shape: the dense sweep)."""
    gen = torch.Generator().manual_seed(n)
    rows = _words(gen, m, n, w, dev=dev)
    rows = torch.where((torch.rand((m, n, w), generator=gen) < share
                        ).to(dev), rows, 0)
    rows[0, 5] = -1                              # every word of a row
    want = greedy_pick.canonical_lists(greedy_pick.compact_rows_plain(rows))
    small = greedy_pick.compact_rows(rows, 3)
    assert small.nonzero_words == want[4].shape[0]
    got = greedy_pick.compact_rows(rows, small.nonzero_words)
    got = got._replace(entries=got.entries[:got.nonzero_words])
    _equal(greedy_pick.canonical_lists(got), want)
    ops.reset_launches()
    lists = greedy_pick.row_lists(rows)
    assert ops.LAUNCHES["compact_rows"] == 1
    assert lists.nonzero_words == want[4].shape[0]
    dense = lists.nonzero_words > greedy_pick.compact_capacity(m * n * w, m)
    assert dense == (n == 4096) == (lists.entries is None)
    if not dense:
        _equal(greedy_pick.canonical_lists(lists), want)


@pytest.mark.parametrize("r,c,w", [(1, 41, 3), (5, 9, 3), (3, 8, 4096),
                                   (2, 13, 4096)])
def test_bucket_insert_stream(dev, r, c, w):
    """Chunks of 8 and 13 candidates at W = 4096 exceed what the shared
    memory stages at once (6): the kernel stages them in parts."""
    gen = torch.Generator().manual_seed(r)
    ids = torch.randint(-1, 60, (r, c), generator=gen, dtype=torch.int32)
    rows = _words(gen, r, c, w, dev=dev)
    for _ in range(4 if w > 64 else 0):          # gains near 3000
        rows &= _words(gen, r, c, w, dev=dev)
    args = (ids.to(dev), rows,
            _words(gen, 9, w, dev=dev) & _words(gen, 9, w, dev=dev),
            torch.tensor([0, 1, 2, 3, 0, 1, 2, 3, 3], dtype=torch.int32,
                         device=dev),
            torch.full((9, 3), -1, dtype=torch.int32, device=dev),
            torch.rand(9, generator=gen).to(dev) * (4000 if w > 64 else 30))
    _equal(bucket_insert.bucket_insert_stream(*args),
           bucket_insert.bucket_insert_stream_plain(*args))
    assert 1 <= bucket_insert.stream_chunk_capacity(4096, dev) < 8


def _check_settled(args):
    """The kernel equals the scan and the grouped walk, and writes the
    walk's figures; returns its stats."""
    *got, stats = bucket_insert.bucket_insert_with_stats(*args)
    plain = (bucket_insert.bucket_insert_stream_plain if args[0].dim() == 2
             else bucket_insert.bucket_insert_plain)
    _equal(got, plain(*args))
    g = bucket_insert.GROUP
    assert (stats[:, 4] == g).all()
    *walk, walk_stats = bucket_insert.bucket_insert_grouped_plain(*args, g)
    _equal(got, walk)
    assert torch.equal(stats[:, :4].cpu(), walk_stats)
    assert (stats[:, 5] == stats[0, 5]).all()
    n = args[0].numel()
    assert (stats[:, 0] <= -(-n // g) + stats[:, 1]).all()
    return stats.cpu()


@pytest.mark.parametrize("regime", ["filling", "rejecting"])
@pytest.mark.parametrize("w", [1024, 4096, 1023, 33])
def test_bucket_insert_regimes(dev, regime, w):
    """The IMM chunk and the round's stream of 800 candidates through 63
    buckets, k = 100, at full and odd W: filling, every bucket is full at
    candidate 99 and reads no row past its group; rejecting, one
    accept a bucket and a pass a group plus one."""
    args = time_receiver.regime_inputs(regime, 800, 63, w, 100, dev)
    for stream in (False, True):
        a = ((args[0].reshape(8, 100), args[1].reshape(8, 100, w), *args[2:])
             if stream else args)
        st = _check_settled(a)
        g = int(st[0, 4])
        if regime == "filling":
            assert st[:, 2].tolist() == [99] * 63
            assert (st[:, 3] <= (100 // g + 1) * g).all()
        else:
            assert (st[:, 0] == -(-800 // g) + (g > 1)).all()


@pytest.mark.parametrize("w", [36, 37, 4096, 1023, 1])
def test_bucket_insert_edge_cases(dev, w):
    """One block a bucket (W = 36, 37, 1) and a cluster of two that split
    its words (W = 4,096 and 1,023), 16-byte and 4-byte words: random
    ids with pads, some buckets full at the start, a row twice in a
    group, a gain equal to a threshold; streams whose chunks straddle
    the groups."""
    gen = torch.Generator().manual_seed(w)
    b, k, c = 9, 5, 150
    ids = torch.randint(-1, 60, (c,), generator=gen, dtype=torch.int32)
    rows = _words(gen, c, w, dev=dev) & _words(gen, c, w, dev=dev)
    rows &= _words(gen, c, w, dev=dev)
    rows[5] = rows[3]
    ids[0] = 7
    covers = _words(gen, b, w, dev=dev) & _words(gen, b, w, dev=dev)
    covers[1] = 0
    thr = (torch.rand(b, generator=gen) * 8 * w).to(dev)
    thr[1] = float(bitset.coverage_size(rows[0]))   # candidate 0's gain
    args = (ids.to(dev), rows, covers,
            torch.tensor([0, 0, 1, 5, 2, 0, 5, 3, 4], dtype=torch.int32,
                         device=dev),
            torch.full((b, k), -1, dtype=torch.int32, device=dev), thr)
    st = _check_settled(args)
    assert (st[[3, 6], 0] == 0).all()                   # full at the start
    assert (st[:, 5] == (2 if w in (4096, 1023) else 1)).all()
    _check_settled((args[0].reshape(10, 15), rows.reshape(10, 15, w),
                    *args[2:]))


def test_round_paths_agree_on_card(dev):
    g = generators.erdos_renyi(500, 4.0, seed=3, device=dev)
    nbr, prob, wt = csr.padded_adjacency(g)
    fwd = csr.padded_forward_adjacency(g)
    outs = []
    for sampler, solver, use_kernel, aggregate in (
            ("packed", "scan", False, "gather"),
            ("kernel", "lazy", True, "gather"),
            ("kernel", "fused", True, "pipeline"),
            ("packed", "scan", False, "pipeline")):
        fn, _, _ = greediris.build_round(
            m=4, n=500, theta=1024, k=6, max_degree=0, sampler=sampler,
            solver=solver, use_kernel=use_kernel, aggregate=aggregate,
            fwd=fwd)
        o = fn(nbr, prob, wt, prng.key(2))
        outs.append((aggregate, o.seeds.tolist(), int(o.coverage)))
    assert outs[0][1:] == outs[1][1:] and outs[2][1:] == outs[3][1:]
    rip = [greediris.build_ripples_round(m=4, n=500, theta=1024, k=6,
                                         use_kernel=u, fwd=fwd)[0](
        nbr, prob, wt, prng.key(2)) for u in (False, True)]
    assert rip[0][0].tolist() == rip[1][0].tolist()
    assert int(rip[0][1]) == int(rip[1][1])


def test_sampler_and_imm_paths_agree_on_card(dev):
    g = generators.erdos_renyi(500, 4.0, seed=3, device=dev)
    nbr, prob, wt = csr.padded_adjacency(g)
    fwd = csr.padded_forward_adjacency(g)
    for model in ("IC", "LT"):
        x = [rrr.sample_incidence(nbr, prob, wt, prng.key(4), theta=256,
                                  n=500, model=model, fwd=fwd,
                                  sampler=sampler, gather=gather)
             for sampler, gather in (("packed", "auto"),
                                     ("kernel", "resident"),
                                     ("kernel", "streamed"))]
        assert torch.equal(x[0], x[1]) and torch.equal(x[0], x[2])
    runs = [imm.imm(g, 5, 0.13, prng.key(1), max_theta=1024, sampler=s,
                    selector=imm.make_randgreedi_selector(
                        4, use_kernel=u, solver=sv))
            for s, u, sv in (("packed", False, "scan"),
                             ("kernel", True, "resident"))]
    assert runs[0].seeds.tolist() == runs[1].seeds.tolist()
    assert runs[0].coverage_fraction == runs[1].coverage_fraction


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    f = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    nbr = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        rrr_expand.rrr_expand_step(f, f, nbr.long(), f[:, None])
    with pytest.raises(ValueError, match="contiguous"):
        rrr_expand.rrr_expand_step(f, f, nbr, torch.zeros_like(
            f[:, None]).repeat(1, 2, 1)[:, :1])
    with pytest.raises(ValueError, match="several devices"):
        rrr_expand.rrr_expand_step(f, f.cpu(), nbr, f[:, None])
    prob = torch.zeros((4, 2), device=dev)
    with pytest.raises(TypeError, match="prob_p"):
        rrr_expand.rrr_expand_step_ic(f, f, nbr, prob.double(),
                                      [prng.key(1)], 2)
    with pytest.raises(ValueError, match="several devices"):
        rrr_expand.rrr_expand_step_ic(f, f, nbr.cpu(), prob,
                                      [prng.key(1)], 2)
    keys = rrr_expand.cascade_keys(prng.key(1), 1, 64, dev)
    with pytest.raises(ValueError, match="lanes"):
        rrr_expand.cascade_step_ic(f, f, nbr, prob[:, :1].contiguous(),
                                   keys, 1, 64, lanes=3)
    with pytest.raises(ValueError, match="several devices"):
        rrr_expand.cascade_step_ic(f, f, nbr, prob[:, :1].contiguous(),
                                   keys.cpu(), 1, 64)
    words = torch.zeros(1, dtype=torch.int32, device=dev)
    listed = torch.empty(8, dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="distinct planes"):
        rrr_expand.rrr_expand_push_ic(words, f, f.clone(), nbr, prob,
                                      [prng.key(1)], 2, f, listed, count)
    big = torch.zeros((1, 2, 70000), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        greedy_pick.greedy_maxcover_resident(big, 1)
    with pytest.raises(ValueError, match="shared memory"):
        lazy_greedy.greedy_maxcover_lazy(big, 1)
    with pytest.raises(ValueError, match="shared memory"):
        coverage.marginal_gain(big, big[:, 0])
    wide = torch.zeros((1, 7, 20000), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="double buffer"):
        bucket_insert.bucket_insert_stream(
            torch.zeros((1, 7), dtype=torch.int32, device=dev), wide,
            wide[0, :2], torch.zeros(2, dtype=torch.int32, device=dev),
            torch.full((2, 1), -1, dtype=torch.int32, device=dev),
            torch.zeros(2, device=dev))


@pytest.mark.parametrize("b", [1, 3, 7, 63, 64, 200])
@pytest.mark.parametrize("w", [1, 3, 33, 2053, 4095, 4096, 4097, 4099,
                               65536])
def test_bucket_gains(dev, b, w):
    """Every cluster size the launch takes (one block a bucket where W is
    narrow or B fills the card, up to 8 blocks a bucket of a long row),
    on 16-byte and 4-byte loads."""
    gen = torch.Generator().manual_seed(b * w)
    row = _words(gen, w + 1, dev=dev)
    covers = _words(gen, b, w + 1, dev=dev) & _words(gen, b, w + 1, dev=dev)
    covers[0] = 0
    _equal([bucket.bucket_gains(row[:w], covers[:, :w].contiguous())],
           [bucket.bucket_gains_plain(row[:w], covers[:, :w])])
    # unaligned starts take the 4-byte path
    _equal([bucket.bucket_gains(row[1:], covers[:, 1:].contiguous())],
           [bucket.bucket_gains_plain(row[1:], covers[:, 1:])])


def test_bucket_gains_cluster(dev):
    """The receiver's shape (B = 63, W = 4,096) splits each bucket over a
    cluster of blocks, as the model says; narrow rows take one block."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, w, vec in ((63, 4096, True), (63, 4097, False), (1, 65536, True),
                      (200, 4096, True), (63, 3, False), (1, 1, False)):
        assert (bucket.launch_cluster(b, w, vec, dev)
                == bucket.cluster_size(b, w, vec, sms))
    assert bucket.launch_cluster(63, 4096, True, dev) > 1
    assert bucket.launch_cluster(63, 3, False, dev) == 1


@pytest.mark.parametrize("n,w,k,b,case", [
    (301, 5, 12, 8, "random"), (2000, 36, 20, 8, "random"),
    (2000, 36, 20, 8, "diverge"),     # the queries' picks diverge
    (301, 5, 12, 1, "random"),        # one query
    (700, 4096, 6, 16, "random"),     # two groups at W = 4096
    (700, 4096, 6, 12, "random"),     # a last group of 4 of its 8 slots
    (700, 4096, 6, 16, "sparse"),     # most 16-byte chunks zero
    (301, 7, 12, 8, "unaligned"),     # odd W, unaligned start: 4-byte loads
])
def test_query_axis_kernels(dev, n, w, k, b, case):
    """B queries over one shared pool: the three query-axis kernels
    equal their plain versions, counted apart from the machine axis,
    with a tie across two tiles in every case."""
    gen = torch.Generator().manual_seed(n)
    words = _words(gen, n * w + 1, dev=dev) & _words(gen, n * w + 1, dev=dev)
    if case == "sparse":                         # ~8 set words a row
        words = torch.where(torch.rand(n * w + 1, generator=gen).to(dev)
                            < 0.002, words, 0)
    rows = (words[1:] if case == "unaligned" else words[:-1]).view(n, w)
    rows[40] = rows[7]                           # a tie across two tiles
    if case == "diverge":                        # a quarter of the rows each
        ex = torch.stack([torch.randperm(n, generator=gen)[:n // 4]
                          for _ in range(b)]).to(torch.int32).to(dev)
    else:
        ex = torch.randint(-1, n, (b, 3), generator=gen, dtype=torch.int32
                           ).to(dev)
        ex[0] = -1
    shared = rows[None].expand(b, n, w)
    ops.reset_launches()
    got = greedy_pick.greedy_maxcover_resident_batch(rows, k, ex)
    _equal(got, greedy_pick.greedy_plain(shared, k, ex))
    if case == "diverge":
        assert len({tuple(s) for s in got[0].tolist()}) == b
    *got, swept = lazy_greedy.greedy_maxcover_lazy_batch(rows, k, ex)
    *want, _ = lazy_greedy.lazy_plain(shared, k, ex)
    _equal(got, want)
    tiles = lazy_greedy.num_row_tiles(n)
    assert all(tiles <= int(t) <= k * tiles for t in swept)
    cov = _words(gen, b, w, dev=dev) & _words(gen, b, w, dev=dev)
    picked = (torch.rand((b, n), generator=gen) < 0.3).to(dev)
    _equal(topk_gain.best_gain_index_batch(rows, cov, picked),
           topk_gain.best_gain_index_plain(shared, cov, picked))
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "greedy_pick_batch": 1, "lazy_greedy_batch": 1, "topk_gain_batch": 1}
    for solver in maxcover.SOLVERS:
        sol = maxcover.greedy_maxcover_batch(rows, ex, k, solver=solver)
        for q in sorted({0, min(5, b - 1), b - 1}):
            one = maxcover.greedy_maxcover(rows, k, solver=solver,
                                           excluded=ex[q])
            _equal([f[q] for f in sol], one)


@pytest.mark.parametrize("w", [3, 4, 5, 64])
@pytest.mark.parametrize("b", [1, 3, 8, 9, 17])
def test_topk_gain_batch(dev, b, w):
    """One pick of B queries over a shared pool equals its plain version:
    one group, several, and a ragged last one (B = 9, 17); the 4-byte
    (W = 3, 5) and the 16-byte paths; two best rows in different blocks
    tie (the lower wins unless its query picked it); a query with every
    row picked gets gain -1 at row 0, as jnp.argmax."""
    n = 3000
    gen = torch.Generator().manual_seed(b * w)
    rows = _words(gen, n, w, dev=dev) & _words(gen, n, w, dev=dev)
    rows[[7, n - 5]] = -1
    cov = _words(gen, b, w, dev=dev) & _words(gen, b, w, dev=dev)
    picked = (torch.rand((b, n), generator=gen) < 0.3).to(dev)
    if b > 1:
        picked[b // 2] = True
    ops.reset_launches()
    got = topk_gain.best_gain_index_batch(rows, cov, picked)
    _equal(got, topk_gain.best_gain_index_plain(rows[None].expand(b, n, w),
                                                cov, picked))
    assert ops.LAUNCHES["topk_gain_batch"] == 1
    if b > 1:
        assert (int(got[0][b // 2]), int(got[1][b // 2])) == (-1, 0)


def test_topk_gain_batch_refuses_a_cover_wider_than_shared_memory(dev):
    """A W whose one cover does not fit a block's shared memory is
    refused with an error, never solved by the plain version."""
    rows = torch.zeros((4, 70000), dtype=torch.int32, device=dev)
    cov = torch.zeros((2, 70000), dtype=torch.int32, device=dev)
    picked = torch.zeros((2, 4), dtype=torch.bool, device=dev)
    ops.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        topk_gain.best_gain_index_batch(rows, cov, picked)
    assert ops.LAUNCHES["topk_gain_batch"] == 0


def test_batched_solve_peak_memory_stays_near_the_pool(dev):
    """The pool is shared, not copied per query: a B = 8 solve over a
    128 MiB pool peaks under the pool's bytes plus 10%."""
    gen = torch.Generator().manual_seed(5)
    rows = _words(gen, 32768, 1024, dev=dev) & _words(gen, 32768, 1024,
                                                       dev=dev)
    ex = torch.full((8, 4), -1, dtype=torch.int32, device=dev)
    pool_bytes = rows.numel() * 4
    for solver in ("resident", "lazy", "fused"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        sol = maxcover.greedy_maxcover_batch(rows, ex, 10, solver=solver)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        assert base >= pool_bytes
        assert peak <= 1.1 * pool_bytes + (base - pool_bytes), solver
        del sol


def test_serve_check_on_card_equals_the_cpu(dev):
    flags = ["--n", "300", "--queries", "8", "--batch", "4", "--theta0",
             "256", "--slab", "128", "--max-theta", "1024", "--k-max", "6",
             "--refresh-every", "1", "--check"]
    for solver in ("lazy", "fused"):
        got = serve.run(flags + ["--solver", solver])
        want = serve.run(flags + ["--solver", solver, "--device", "cpu",
                                  "--sampler", "packed"])
        assert got["rc"] == 0 and want["rc"] == 0
        assert all(serve.answers_equal(a, b)
                   for a, b in zip(got["answers"], want["answers"]))


# ------------------------------------------------ the launch and footprint
# checker (repro_torch.analysis) and the shared-memory model

def _model_shapes():
    """(kernel, W, x) of every full-size shape (smem_budget.FULL_SIZE)
    and of every contract fixture (its declared shapes, on the CPU)."""
    out = {(k, w, x) for k, shapes in smem_budget.FULL_SIZE.items()
           for _, w, x in shapes}
    for c in contracts.build_registry():
        fixture = c.build(torch.device("cpu"))
        out |= {(k, *fixture.shapes[k]) for k, n in c.launches.items() if n}
    return sorted(out)


def test_smem_model_equals_the_c_side(dev):
    """The model's dynamic figure equals each library's ``launch_smem`` at
    every fixture and full-size shape, its static figure the largest
    ``cudaFuncGetAttributes`` of the launch's device functions, its budget
    the card's opt-in limit, and the query budgets and the receiver's
    chunk capacity the C side's."""
    table = contracts.device_kernels(dev)
    assert set(table) == set(ops.KERNELS)
    for kernel, w, x in _model_shapes():
        lib = table[kernel][0]["lib"]
        assert (contracts.c_launch_bytes(lib, kernel, w, x, dev)
                == smem_budget.launch_bytes(kernel, w, x)), (kernel, w, x)
    for kernel, entries in table.items():
        assert (max(e["static_smem"] for e in entries)
                == smem_budget.STATIC_BYTES[kernel]), kernel
    assert smem_budget.budget_bytes(dev) == smem_budget.HOPPER_OPTIN_BYTES
    for lib in ("greedy_pick", "lazy_greedy", "topk_gain"):
        assert smem_budget.query_budget(lib, dev) == smem_budget.query_budget(
            lib)
    for w in (1, 11, 1024, 4096, 20000, 60000):
        assert (bucket_insert.stream_chunk_capacity(w, dev)
                == smem_budget.stream_chunk_capacity(w, dev))


def test_no_local_memory_where_contracts_allow_none(dev):
    """No device function of a contract's launches keeps local memory (a
    stack frame or spills) unless the contract allows it."""
    table = contracts.device_kernels(dev)
    for c in contracts.build_registry():
        for kernel, n in c.launches.items():
            if n and kernel not in c.local_memory:
                assert all(e["local_bytes"] == 0 for e in table[kernel]), (
                    c.name, kernel, table[kernel])


@pytest.mark.parametrize("name", [
    "rrr_expand.resident", "rrr_expand.streamed", "rrr_expand.lt",
    "greedy_pick.resident", "greedy_pick.scan_ref", "greedy_pick.dense",
    "lazy_greedy.resident", "lazy_greedy.dense", "lazy_greedy.batch",
    "topk_gain.fused", "topk_gain.batch", "coverage.ripples",
    "bucket_insert.chunk", "bucket_insert.stream", "bucket_insert.scan_ref",
    "bucket.gains", "cascade.kernel", "cascade.lt", "cascade.resident",
    "service.batched"])
def test_contract_on_card(dev, name):
    """Each contract holds on the card (launch counts, layout, dtypes,
    shared memory, local memory, co-residency), and its fixture gives the
    plain versions' outputs on the CPU."""
    c = contracts.contracts_by_name()[name]
    report = contracts.run_contract(c, dev)
    assert report.ok, report.violations
    assert report.stats["launches"] or not any(c.launches.values())
    got = _leaves(c.build(dev).fn())
    want = _leaves(c.build(torch.device("cpu")).fn())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b), name


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _leaves(y)]


@pytest.mark.parametrize("solve", ["resident", "dense", "lazy"])
def test_machine_solves_past_2_31_words(dev, solve):
    """The machine-axis solves index rows [m, n, W] in 64 bits: one
    machine of 2^31 + 2^21 words whose picks lie past word 2^31 (the
    compact layout, the dense sweep forced by cap 0, the lazy solve)."""
    n, w = (1 << 16) + 64, 1 << 15
    rows = torch.zeros((1, n, w), dtype=torch.int32, device=dev)
    rows[0, n - 1, w - 4:] = -1                      # 128 bits
    rows[0, n - 2, :2] = 0x0F0F0F0F                  # 32
    rows[0, 5, 7] = 0xFF                             # 8
    ex = greedy_pick.excluded_ids(None, 1, dev)
    if solve == "resident":
        out = greedy_pick.greedy_maxcover_resident(rows, 3)
    elif solve == "dense":
        out = greedy_pick.greedy_dense(rows, 3, ex, cap=0)
    else:
        out = lazy_greedy.greedy_maxcover_lazy(rows, 3)
    seeds, sel, covered, gains = out[:4]
    assert seeds.tolist() == [[n - 1, n - 2, 5]]
    assert gains.tolist() == [[128, 32, 8]]
    assert torch.equal(sel[0, 0], rows[0, n - 1])
    assert int(bitset.coverage_size(covered)) == 168
