"""Port parity: the fixed-theta GreediRIS round and the Ripples baseline
round against ``repro.core.greediris`` on a mesh of 8 fake host devices.
Seeds, coverage, global coverage and best-local coverage are equal bit
for bit (tolerance zero) in every configuration: the four solvers, both
receivers with chunked and automatic chunk sizes, both schedules, both
shuffles (one overflowing its capacity), truncation and a dropped
machine, under IC and LT.

The reference runs once per session, every configuration in one
subprocess (the mesh's device count is fixed when jax starts)."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import greediris  # noqa: E402
from repro_torch.graphs import csr  # noqa: E402
from tests.conftest import run_with_devices  # noqa: E402
from tests.test_torch_ref import partitionable, port_graph, port_key  # noqa: E402,F401

N, THETA, K, M, SEED = 200, 512, 8, 8, 1
DROP = 3
SURVIVORS = tuple(j for j in range(M) if j != DROP)

# name -> (model, arguments of both packages' build_round)
ROUNDS = {
    "scan": ("IC", {}),
    "fused-kernel-c8": ("IC", dict(solver="fused", use_kernel=True,
                                   chunk_size=8)),
    "resident-kernel-auto": ("IC", dict(solver="resident", use_kernel=True,
                                        chunk_size="auto")),
    "lazy-kernel": ("IC", dict(solver="lazy", use_kernel=True)),
    "scan-c8": ("IC", dict(chunk_size=8)),
    "pipeline": ("IC", dict(aggregate="pipeline")),
    "pipeline-kernel-lazy": ("IC", dict(aggregate="pipeline", use_kernel=True,
                                        solver="lazy")),
    "sparse": ("IC", dict(shuffle="sparse")),
    "trunc": ("IC", dict(alpha_trunc=0.125, use_kernel=True, solver="fused")),
    "survivor": ("IC", dict(survivors=SURVIVORS)),
    "survivor-pipeline": ("IC", dict(survivors=SURVIVORS,
                                     aggregate="pipeline", use_kernel=True,
                                     solver="resident")),
    "lt-scan": ("LT", {}),
    "lt-lazy-kernel-auto": ("LT", dict(solver="lazy", use_kernel=True,
                                       chunk_size="auto")),
    "lt-sparse-overflow": ("LT", dict(shuffle="sparse", est_rrr_len=0.5)),
}
# name -> (model, arguments of both packages' build_ripples_round)
RIPPLES = {
    "ripples": ("IC", {}),
    "ripples-kernel": ("IC", dict(use_kernel=True)),
    "ripples-lt-kernel": ("LT", dict(use_kernel=True)),
}

REFERENCE = """
import json, jax, numpy as np
jax.config.update("jax_threefry_partitionable", True)
from repro.core import greediris
from repro.graphs import generators
from repro.graphs.csr import padded_adjacency, padded_forward_adjacency
from repro.runtime.jaxcompat import make_mesh
N, THETA, K, M, SEED = {consts}
rounds, ripples = json.loads({rounds!r}), json.loads({ripples!r})
g = generators.erdos_renyi(N, 8.0, seed=SEED)
nbr, prob, wt = padded_adjacency(g)
fwd = padded_forward_adjacency(g)
key = jax.random.key(0)
mesh = make_mesh((M,), ("machines",))
out = {{}}
for name, (model, kw) in rounds.items():
    if "survivors" in kw:
        kw["survivors"] = tuple(kw["survivors"])
    fn, _, _ = greediris.build_round(
        mesh, ("machines",), n=N, theta=THETA, k=K, model=model,
        max_degree=g.max_in_degree(), sampler="packed", fwd=fwd, **kw)
    o = jax.jit(fn)(nbr, prob, wt, key)
    out[name] = [np.asarray(o.seeds).tolist(), int(o.coverage),
                 int(o.global_coverage), int(o.best_local_coverage)]
for name, (model, kw) in ripples.items():
    fn, _ = greediris.build_ripples_round(
        mesh, ("machines",), n=N, theta=THETA, k=K, model=model, **kw)
    s, c = jax.jit(fn)(nbr, prob, wt, key)
    out[name] = [np.asarray(s).tolist(), int(c)]
print(json.dumps(out))
"""


@pytest.fixture(scope="session")
def reference():
    code = REFERENCE.format(consts=(N, THETA, K, M, SEED),
                            rounds=json.dumps(ROUNDS),
                            ripples=json.dumps(RIPPLES))
    return json.loads(run_with_devices(code, M).strip().splitlines()[-1])


@pytest.fixture(scope="module")
def tables():
    from repro.graphs import generators
    g = port_graph(generators.erdos_renyi(N, 8.0, seed=SEED))
    return (*csr.padded_adjacency(g), csr.padded_forward_adjacency(g))


def _key():
    import jax
    return port_key(jax.random.key(0))


def _round(tables, model, kw, stats=None, sampler="packed"):
    nbr, prob, wt, fwd = tables
    fn, _, _ = greediris.build_round(m=M, n=N, theta=THETA, k=K, model=model,
                                     max_degree=0, sampler=sampler, fwd=fwd,
                                     **kw)
    return fn(nbr, prob, wt, _key(), stats=stats)


@pytest.mark.parametrize("name", list(ROUNDS))
def test_round_matches_reference(reference, tables, name):
    model, kw = ROUNDS[name]
    # the kernel sampler's plain version on the CPU for kernel paths
    sampler = "kernel" if kw.get("use_kernel") else "packed"
    out = _round(tables, model, kw, sampler=sampler)
    got = [out.seeds.tolist(), int(out.coverage), int(out.global_coverage),
           int(out.best_local_coverage)]
    assert got == reference[name]


@pytest.mark.parametrize("name", list(RIPPLES))
def test_ripples_round_matches_reference(reference, tables, name):
    """The reference samples with its dense sampler, the port with the
    packed one: the sampler contract makes them bit-identical."""
    model, kw = RIPPLES[name]
    nbr, prob, wt, fwd = tables
    fn, theta = greediris.build_ripples_round(m=M, n=N, theta=THETA, k=K,
                                              model=model, fwd=fwd, **kw)
    assert theta == THETA
    seeds, cov = fn(nbr, prob, wt, _key())
    assert [seeds.tolist(), int(cov)] == reference[name]


@pytest.mark.parametrize("model,est,dropped", [
    ("IC", 16.0, False), ("LT", 0.5, True)])
def test_sparse_shuffle_capacity(reference, tables, model, est, dropped):
    """A generous ``est_rrr_len`` drops nothing and equals the dense
    shuffle; a small one overflows and drops pairs — the same pairs as
    the reference, so the round still matches it."""
    stats = {}
    out = _round(tables, model, dict(shuffle="sparse", est_rrr_len=est),
                 stats)
    assert (stats["shuffle_dropped_pairs"] > 0) == dropped
    dense = _round(tables, model, {})
    if dropped:
        assert out.seeds.tolist() == reference["lt-sparse-overflow"][0]
        assert out.seeds.tolist() != dense.seeds.tolist()
    else:
        assert out.seeds.tolist() == dense.seeds.tolist()


def test_dead_machine_block_never_reaches_the_seeds(tables):
    """Machine j owns ``perm[j*per:(j+1)*per]`` of the random vertex
    permutation, not a contiguous id range: with machine DROP dead, no
    vertex of its true block is a seed, and its local solution drops out
    of the merge."""
    n_pad = -(-N // M) * M
    per = n_pad // M
    perm = _key().fold_in(0x9E37).permutation(n_pad, device="cpu").tolist()
    dead = set(perm[DROP * per:(DROP + 1) * per])
    assert dead != set(range(DROP * per, (DROP + 1) * per))
    full = _round(tables, "IC", {})
    for agg in ("gather", "pipeline"):
        out = _round(tables, "IC", dict(survivors=SURVIVORS, aggregate=agg))
        assert not dead & set(out.seeds.tolist())
        assert int(out.best_local_coverage) <= int(full.best_local_coverage)


def test_stage_seconds_and_validation(tables):
    stats = {}
    _round(tables, "IC", dict(solver="lazy"), stats)
    assert set(stats) >= {"sample_shuffle_s", "senders_s", "receiver_s",
                          "merge_s"}
    assert all(v >= 0 for v in stats.values())
    for bad in (dict(chunk_size=0), dict(chunk_size="big"),
                dict(aggregate="ring"), dict(shuffle="coo"),
                dict(solver="heap"), dict(survivors=(M,))):
        with pytest.raises(ValueError):
            _round(tables, "IC", bad)
    with pytest.raises(ValueError, match="sample_chunks"):
        _round(tables, "IC", dict(sample_chunks=3))


def test_results_do_not_depend_on_chunk_size(tables):
    want = _round(tables, "IC", {})
    for cs in (1, 5, 64, "auto", None):
        out = _round(tables, "IC", dict(use_kernel=True, chunk_size=cs))
        assert out.seeds.tolist() == want.seeds.tolist()
        assert int(out.coverage) == int(want.coverage)
