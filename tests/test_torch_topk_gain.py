"""Port parity: the fused gain sweep + argmax of one pick
(``kernels.topk_gain``) against the reference's ``best_gain_index_pallas``
in interpret mode, on the machine axis and vmapped over queries as the
reference's batched solver runs it, and ``solver="fused"`` against the
reference's fused solver, alone and batched — exact, at unaligned shapes
with ties and picked rows.  Also the query axis's group plan as the
wrapper hands it to the kernel, with the C side replaced by a stand-in
(the kernel itself runs only on the card, tests/test_torch_cuda.py)."""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import maxcover as ref  # noqa: E402
from repro.kernels.topk_gain import best_gain_index_pallas  # noqa: E402
from repro_torch.core import maxcover  # noqa: E402
from repro_torch.kernels import build, greedy_pick, ops, topk_gain  # noqa: E402
from tests.test_torch_ref import partitionable, to_port, u32, words  # noqa: E402,F401


@pytest.mark.parametrize("m,n,w,picked_frac", [
    (1, 1, 1, 0.0), (3, 37, 5, 0.3), (2, 130, 33, 0.5), (2, 11, 2, 1.0)])
def test_best_gain_index_matches_pallas(m, n, w, picked_frac):
    rng = np.random.default_rng(m * n + w)
    rows = words(rng, (m, n, w), density=0.2)
    rows[:, n // 2] = rows[:, 0]                  # a tie: lowest index wins
    cov = words(rng, (m, w), density=0.2)
    picked = rng.random((m, n)) < picked_frac
    best, index = topk_gain.best_gain_index(to_port(rows), to_port(cov),
                                            torch.from_numpy(picked))
    for j in range(m):
        want = best_gain_index_pallas(jnp.asarray(rows[j]),
                                      jnp.asarray(cov[j]),
                                      jnp.asarray(picked[j]), interpret=True)
        assert (int(best[j]), int(index[j])) == tuple(map(int, want))


@pytest.mark.parametrize("n,w,k,excl", [(45, 4, 6, [2, 5]), (6, 1, 9, [0]),
                                        (70, 3, 12, [-1])])
def test_fused_solver_matches_reference(n, w, k, excl):
    rows = words(np.random.default_rng(n), (n, w), density=0.2)
    rows[7 % n] = rows[1 % n]
    want = ref.greedy_maxcover(jnp.asarray(rows), k, solver="fused",
                               excluded=jnp.asarray(excl, jnp.int32))
    got = maxcover.greedy_maxcover(to_port(rows), k, solver="fused",
                                   excluded=excl)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(u32(a), u32(b))


def test_no_rows_raise():
    z = torch.zeros((1, 0, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="at least one row"):
        topk_gain.best_gain_index(z, torch.zeros((1, 2), dtype=torch.int32),
                                  torch.zeros((1, 0), dtype=torch.bool))


@pytest.mark.parametrize("b,n,w", [(1, 37, 5), (3, 40, 4), (9, 70, 3),
                                   (17, 45, 6), (8, 11, 2)])
def test_best_gain_index_batch_matches_vmapped_pallas(b, n, w):
    """B queries over one shared pool, several groups' worth of them on
    the card: two all-ones rows far apart tie as the best (the lower one
    wins unless picked), picked rows score -1 for their own query only,
    and a query with every row picked gets (-1, 0) as jnp.argmax."""
    rng = np.random.default_rng(b * n + w)
    rows = words(rng, (n, w), density=0.2)
    rows[[2, n - 3]] = np.uint32(0xFFFFFFFF)
    cov = words(rng, (b, w), density=0.2)
    picked = rng.random((b, n)) < 0.3
    if b > 1:
        picked[b // 2] = True
    best, index = topk_gain.best_gain_index_batch(
        to_port(rows), to_port(cov), torch.from_numpy(picked))
    want = jax.vmap(lambda c, p: best_gain_index_pallas(
        jnp.asarray(rows), c, p, interpret=True))(jnp.asarray(cov),
                                                  jnp.asarray(picked))
    np.testing.assert_array_equal(best.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(index.numpy(), np.asarray(want[1]))
    if b > 1:
        assert (int(best[b // 2]), int(index[b // 2])) == (-1, 0)


@pytest.mark.parametrize("b,n,w,k", [(9, 60, 3, 7), (17, 45, 4, 5),
                                     (3, 30, 5, 12)])
def test_fused_batch_matches_reference(b, n, w, k):
    rng = np.random.default_rng(b + n)
    rows = words(rng, (n, w), density=0.2)
    rows[n - 3] = rows[1]
    ex = rng.integers(-1, n, (b, 3)).astype(np.int32)
    ex[0] = -1
    want = ref.greedy_maxcover_batch(jnp.asarray(rows), jnp.asarray(ex), k,
                                     solver="fused")
    got = maxcover.greedy_maxcover_batch(to_port(rows), torch.from_numpy(ex),
                                         k, solver="fused")
    for a, c in zip(got, want):
        np.testing.assert_array_equal(u32(a), u32(c))


@pytest.mark.parametrize("b,w,budget", [
    (8, 4096, 229_000),      # the serving batch: one group of 8
    (17, 36, 229_000),       # groups of 8, 8 and 1
    (9, 20000, 229_000),     # the budget holds two covers: G = 2
    (3, 70000, 229_000),     # not even one cover fits: refused
])
def test_batch_wrapper_plans_groups_and_refuses(monkeypatch, b, w, budget):
    """On the card, the query axis hands the kernel the G that
    ``greedy_pick.query_groups`` plans from the budget the kernel
    exports (G covers fit it, ceil(B / G) groups), and a cover that does
    not fit alone raises — it never falls back to the plain version.
    The card and the C side are stand-ins here: the wrapper's device
    checks pass, and the entry point refuses as the kernel does (-2)."""
    calls = []

    def function(lib, fn, argtypes):
        assert lib == "topk_gain"
        if fn == "topk_gain_batch_budget":
            return lambda: budget

        def batch(*args):
            assert fn == "best_gain_index_batch"
            assert len(args) == len(argtypes)          # the stream last
            calls.append(args[6:10])                   # B, n, W, G
            return -2 if 4 * args[9] * args[8] > budget else 0
        return batch

    monkeypatch.setattr(ops, "on_card", lambda *t: True)
    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(torch.cuda, "device", _NoDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    n = 5
    rows = torch.zeros((n, w), dtype=torch.int32)
    cov = torch.zeros((b, w), dtype=torch.int32)
    picked = torch.zeros((b, n), dtype=torch.bool)
    g, groups = greedy_pick.query_groups(b, w, budget)
    before = ops.LAUNCHES["topk_gain_batch"]
    if 4 * w > budget:
        with pytest.raises(ValueError, match="shared memory"):
            topk_gain.best_gain_index_batch(rows, cov, picked)
        assert ops.LAUNCHES["topk_gain_batch"] == before
    else:
        topk_gain.best_gain_index_batch(rows, cov, picked)
        assert ops.LAUNCHES["topk_gain_batch"] == before + 1
        assert 4 * g * w <= budget and groups == -(-b // g)
    assert calls == [(b, n, w, g)]


class _NoDevice:
    """``torch.cuda.device`` for a test without a card: a no-op context."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
