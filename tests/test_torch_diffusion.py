"""Port parity: threshold-semantics LT (``diffusion.lt_threshold_influence``)
against ``repro.core.diffusion``'s, bit for bit (tolerance zero) on the
same graph, seeds and key, and the live-edge LT spread against the
threshold one within the reference's own statistical bound."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import diffusion as ref  # noqa: E402
from repro.graphs import csr as ref_csr  # noqa: E402
from repro.graphs import generators as ref_generators  # noqa: E402
from repro_torch.core import diffusion  # noqa: E402
from tests.test_torch_ref import (partitionable, port_graph,  # noqa: E402,F401
                                  port_key)


@pytest.mark.parametrize("n,avg_deg,seed,num_sims,max_steps,seeds", [
    (45, 5.0, 8, 32, 2, [0, 5]),
    (45, 5.0, 8, 32, 64, [0, 5]),
    (120, 4.0, 1, 64, 64, [3, -1, 250, 9]),
    (200, 8.0, 2, 33, 64, [1, 2, 3, -1]),
    (200, 3.0, 3, 1, 64, [7]),
    (150, 6.0, 4, 64, 3, list(range(0, 150, 10))),
    (80, 5.0, 5, 100, 64, [2, 11]),
    (60, 4.0, 6, 7, 64, [0, 1, 2, -1, -1]),
])
def test_lt_threshold_matches_reference(n, avg_deg, seed, num_sims,
                                        max_steps, seeds):
    g_ref = ref_generators.erdos_renyi(n, avg_deg, seed=seed)
    jk = jax.random.key(seed + 9)
    want = ref.lt_threshold_influence(g_ref, np.asarray(seeds), jk,
                                      num_sims=num_sims, max_steps=max_steps)
    got = diffusion.lt_threshold_influence(
        port_graph(g_ref), torch.tensor(seeds), port_key(jk),
        num_sims=num_sims, max_steps=max_steps)
    assert got.dtype == torch.float32
    assert float(got) == float(want)


def test_lt_threshold_chain_and_edgeless():
    """A chain of weight-1 in-edges activates wholly from its head and
    stops after max_steps; an edgeless graph keeps the seeds alone."""
    n = 9
    chain = port_graph(ref_csr.from_edge_list(
        np.arange(n - 1), np.arange(1, n), n,
        probs=np.ones(n - 1, dtype=np.float32)))
    key = port_key(jax.random.key(6))
    assert float(diffusion.lt_threshold_influence(
        chain, torch.tensor([0]), key, num_sims=8)) == float(n)
    assert float(diffusion.lt_threshold_influence(
        chain, torch.tensor([0]), key, num_sims=8, max_steps=3)) == 4.0
    edgeless = port_graph(ref_csr.from_edge_list(
        np.zeros(0, np.int64), np.zeros(0, np.int64), 5))
    assert float(diffusion.lt_threshold_influence(
        edgeless, torch.tensor([0, 3, -1]), key, num_sims=8)) == 2.0


def test_lt_live_edge_matches_threshold_distribution():
    """Kempe et al.'s equivalence: the live-edge and the threshold form
    estimate the same sigma, within the reference's bound at 300
    simulations, and each equals the reference's estimate."""
    g_ref = ref_generators.erdos_renyi(60, 5.0, seed=9)
    g = port_graph(g_ref)
    seeds = torch.tensor([0, 3])
    a = float(diffusion.influence(g, seeds, port_key(jax.random.key(0)),
                                  model="LT", num_sims=300))
    b = float(diffusion.lt_threshold_influence(
        g, seeds, port_key(jax.random.key(1)), num_sims=300))
    assert abs(a - b) <= 0.25 * max(a, b)
    assert a == float(ref.influence(g_ref, np.array([0, 3]),
                                    jax.random.key(0), model="LT",
                                    num_sims=300))
    assert b == float(ref.lt_threshold_influence(
        g_ref, np.array([0, 3]), jax.random.key(1), num_sims=300))
