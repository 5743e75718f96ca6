"""The port's encoder-decoder (``repro_torch.models.encdec``) against the
reference's ``repro.models.encdec`` on the seamless SMOKE width, the
reference's parameters carried across with
``convert.params_from_reference`` (norms redrawn from a numpy seed):
``encode`` (bidirectional) and ``decode`` with no cache, fp32 at rtol
1e-4, atol 1e-5 and bf16 at 0.05; ``decode`` with caches (a prefill
then three one-token steps, each step's logits and the stacked cache);
the caches' layout; and a one-layer stack, whose leaves keep their
[1] axis."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import encdec as ref_encdec  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import common, encdec  # noqa: E402
from tests import lm_ref  # noqa: E402
from tests.test_torch_ref import partitionable  # noqa: E402,F401

ARCH = "seamless-m4t-large-v2"
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=0.05, atol=0.05)


def _both(f32, s=12, **cfg_kw):
    rc, cfg = lm_ref.configs(ARCH, f32)
    rc, cfg = (dataclasses.replace(rc, **cfg_kw),
               dataclasses.replace(cfg, **cfg_kw))
    npp = lm_ref.ref_params(rc, 0)
    nb = lm_ref.batch(rc, 0, s=s, extra=0)
    return (rc, lm_ref.to_jax(npp), lm_ref.to_jax(nb), cfg,
            convert.params_from_reference(npp, cfg, device="cpu"),
            convert.batch_from_reference(nb, device="cpu"))


@pytest.mark.parametrize("f32", [True, False])
def test_encode_matches_reference(f32):
    rc, jp, jb, cfg, tp, tb = _both(f32)
    want = ref_encdec.encode(jp, rc, {}, jb["frames"])
    got = encdec.encode(tp, cfg, {}, tb["frames"])
    assert got.dtype == cfg.cdtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(lm_ref.f32(got), lm_ref.f32(want),
                               **(F32_TOL if f32 else BF16_TOL))


def test_encoder_is_bidirectional():
    """Changing the last frame moves the encoding of the first."""
    _, _, _, cfg, tp, tb = _both(True)
    frames = tb["frames"].clone()
    a = encdec.encode(tp, cfg, {}, frames)
    frames[:, -1] += 1.0
    b = encdec.encode(tp, cfg, {}, frames)
    assert not torch.allclose(a[:, 0], b[:, 0])


@pytest.mark.parametrize("f32", [True, False])
def test_decode_without_cache_matches_reference(f32):
    rc, jp, jb, cfg, tp, tb = _both(f32)
    enc = ref_encdec.encode(jp, rc, {}, jb["frames"])
    want, wc = ref_encdec.decode(jp, rc, {}, jb["tokens"][:, :9], enc)
    got, gc = encdec.decode(tp, cfg, {}, tb["tokens"][:, :9],
                            convert.tensor_from_reference(np.asarray(enc),
                                                          device="cpu"))
    assert wc is None and gc is None
    np.testing.assert_allclose(lm_ref.f32(got), lm_ref.f32(want),
                               **(F32_TOL if f32 else BF16_TOL))


@pytest.mark.parametrize("f32", [True, False])
def test_decode_with_caches_matches_reference(f32):
    """Prefill 6 tokens into the stacked cache, then three one-token
    steps: each step's logits, and the caches after the last, with the
    cross keys recomputed from the same encoder output each step."""
    rc, jp, jb, cfg, tp, tb = _both(f32)
    tol = F32_TOL if f32 else BF16_TOL
    enc = ref_encdec.encode(jp, rc, {}, jb["frames"])
    tenc = convert.tensor_from_reference(np.asarray(enc), device="cpu")
    jc = ref_encdec.init_caches(rc, 2, 12, rc.cdtype)
    tc = encdec.init_caches(cfg, 2, 12, cfg.cdtype, "cpu")
    want, jc = ref_encdec.decode(jp, rc, {}, jb["tokens"][:, :6], enc,
                                 caches=jc)
    got, tc = encdec.decode(tp, cfg, {}, tb["tokens"][:, :6], tenc,
                            caches=tc)
    np.testing.assert_allclose(lm_ref.f32(got), lm_ref.f32(want), **tol)
    for i in range(6, 9):
        pos = np.asarray([i], np.int32)
        want, jc = ref_encdec.decode(jp, rc, {}, jb["tokens"][:, i:i + 1],
                                     enc, positions=jnp.asarray(pos),
                                     caches=jc)
        got, tc = encdec.decode(tp, cfg, {}, tb["tokens"][:, i:i + 1], tenc,
                                positions=torch.from_numpy(pos), caches=tc)
        np.testing.assert_allclose(lm_ref.f32(got), lm_ref.f32(want), **tol)
    for name, g, w in zip(tc._fields, tc, jc):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(lm_ref.f32(g), lm_ref.f32(w), **tol,
                                   err_msg=name)


def test_caches_are_one_stacked_kv_cache():
    rc, cfg = lm_ref.configs(ARCH)
    want = ref_encdec.init_caches(rc, 3, 10, jnp.bfloat16)
    got = encdec.init_caches(cfg, 3, 10, torch.bfloat16, "cpu")
    assert type(got).__name__ == "KVCache" == type(want).__name__
    for name, g, w in zip(got._fields, got, want):
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
        np.testing.assert_array_equal(lm_ref.f32(g), lm_ref.f32(w))


def test_one_layer_stacks_keep_their_axis():
    """``_stack`` always stacks: with one encoder and one decoder layer
    every leaf still has a leading [1] axis, as the reference's vmap
    gives, and the tree converts and runs."""
    rc, cfg = lm_ref.configs(ARCH)
    rc, cfg = (dataclasses.replace(rc, num_layers=1, encoder_layers=1),
               dataclasses.replace(cfg, num_layers=1, encoder_layers=1))
    want, wspecs = ref_encdec.init_model(jax.random.key(0), rc)
    got, gspecs = encdec.init_model(common.generator(0, "cpu"), cfg)
    w, g = lm_ref.leaves(want), lm_ref.leaves(got)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(w, g):
        assert tuple(b.shape) == a.shape, k
    assert gspecs == wspecs
    assert got["encoder"]["ln1"].shape == (1, cfg.d_model)
    tokens = torch.zeros((1, 3), dtype=torch.int32)
    frames = torch.zeros((1, 4, cfg.d_model), dtype=torch.bfloat16)
    logits, _ = encdec.decode(got, cfg, {}, tokens,
                              encdec.encode(got, cfg, {}, frames))
    assert logits.shape == (1, 3, cfg.vocab_size)


def test_remat_gives_the_same_gradients():
    """fp32: ``remat`` (``torch.utils.checkpoint`` over each layer) and
    no remat give the same gradients."""
    _, _, _, cfg, tp, tb = _both(True)
    from repro_torch.train import steps
    batch = {"tokens": torch.cat([tb["tokens"], tb["tokens"][:, :1]], 1),
             "frames": tb["frames"]}
    _, _, g0 = steps.loss_and_grads(tp, cfg, {}, batch)
    _, _, g1 = steps.loss_and_grads(
        tp, dataclasses.replace(cfg, remat=True), {}, batch)
    for (k, a), (_, b) in zip(lm_ref.leaves(g0), lm_ref.leaves(g1)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **F32_TOL,
                                   err_msg=k)
