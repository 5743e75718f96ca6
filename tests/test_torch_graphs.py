"""Port parity: graph generators and padded tables against
``repro.graphs`` (exact), including truncated pad widths."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.graphs import csr as ref_csr  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro_torch.graphs import csr, generators  # noqa: E402
from tests.test_torch_ref import partitionable, port_graph  # noqa: E402,F401

BUILDERS = {
    "er": (lambda m: m.erdos_renyi, (120, 3.0, 4)),
    "ba": (lambda m: m.preferential_attachment, (60, 3, 2)),
    "rmat": (lambda m: m.rmat, (7, 400, 0.57, 0.19, 0.19, 5)),
    "star": (lambda m: m.star, (33, 1)),
}


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_generators_same_arrays(kind):
    pick, args = BUILDERS[kind]
    g_ref = pick(ref_gen)(*args)
    g = pick(generators)(*args, device="cpu")
    for name in ("indptr", "indices", "probs", "weights"):
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      np.asarray(getattr(g_ref, name)))
    assert g.max_in_degree() == g_ref.max_in_degree()


@pytest.mark.parametrize("pad_to", [None, 2])
def test_padded_adjacency(pad_to):
    g_ref = ref_gen.rmat(7, 500, seed=3)
    want = ref_csr.padded_adjacency(g_ref, pad_to=pad_to)
    got = csr.padded_adjacency(port_graph(g_ref), pad_to=pad_to)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("pad_to,rev_pad_to", [(None, None), (3, 2)])
def test_padded_forward_adjacency(pad_to, rev_pad_to):
    g_ref = ref_gen.rmat(7, 500, seed=3)
    want = ref_csr.padded_forward_adjacency(g_ref, pad_to, rev_pad_to)
    got = csr.padded_forward_adjacency(port_graph(g_ref), pad_to, rev_pad_to)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_to_dense_prob(kind):
    """The dense [n, n] matrix P[v, u] = p(u -> v), as numpy float32;
    rmat's repeated edges keep the later one, as the reference's loop."""
    pick, args = BUILDERS[kind]
    g_ref = pick(ref_gen)(*args)
    got = csr.to_dense_prob(port_graph(g_ref))
    want = ref_csr.to_dense_prob(g_ref)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
