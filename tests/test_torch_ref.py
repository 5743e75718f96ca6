"""Shared pieces of the port's parity tests (``tests/test_torch_*.py``):
the reference pinned to partitionable threefry, and numpy bridges.
Holds no tests itself.

Importing ``partitionable`` into a test module makes it autouse there.
"""
from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("torch")


@pytest.fixture(autouse=True)
def partitionable():
    """Run the reference with ``jax_threefry_partitionable=True`` (the
    only mode the port's PRNG twin implements), restoring the old value
    afterwards — the jax CI pin defaults to False."""
    import jax
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def u32(x) -> np.ndarray:
    """Words of either package (torch int32 or jax uint32) as numpy
    uint32 bit patterns."""
    return np.asarray(x.cpu().numpy() if hasattr(x, "cpu") else x
                      ).astype(np.uint32)


def graphs(n: int, avg_deg: float, seed: int):
    """(reference graph, port graph on the CPU) of the same ER draw."""
    from repro.graphs import generators
    g = generators.erdos_renyi(n, avg_deg, seed=seed)
    return g, port_graph(g)


def port_graph(g):
    from repro_torch import convert
    return convert.graph_from_reference(
        np.asarray(g.indptr), np.asarray(g.indices), np.asarray(g.probs),
        np.asarray(g.weights), device="cpu")


def port_key(jkey):
    import jax

    from repro_torch import convert
    return convert.key_from_reference(np.asarray(jax.random.key_data(jkey)))


def words(rng: np.random.Generator, shape, density: float = 0.5):
    """Random uint32 words with the high bit set often (density of the
    AND of draws controls sparsity)."""
    x = rng.integers(0, 2**32, shape, dtype=np.uint32)
    if density < 0.5:
        x &= rng.integers(0, 2**32, shape, dtype=np.uint32)
    if density < 0.25:
        x &= rng.integers(0, 2**32, shape, dtype=np.uint32)
    return x


def to_port(u32_words):
    from repro_torch import convert
    return convert.words_from_reference(u32_words, device="cpu")
