"""The port's AdamW and gradient compression (``repro_torch.optim``)
against the reference's ``repro.optim``: one AdamW update on the same
gradients (parameters, both moments, the gradient norm and the learning
rate), the schedule, top-k compression (ids and values exact, ties to
the lower index), ``compressed_psum`` against the reference under
``jax.vmap`` with a named axis, and int8 quantization (exact)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import compress as ref_compress  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.optim import adamw, compress  # noqa: E402
from tests import lm_ref  # noqa: E402
from tests.test_torch_ref import partitionable, port_key  # noqa: E402,F401

# AdamW's update is elementwise fp32 arithmetic on equal inputs: the
# one difference is the last place of the float32 ``pow`` and ``cos``
# (XLA's against torch's) in the bias corrections and the schedule.
RTOL, ATOL = 1e-6, 1e-9


def _tree(rng, dtype):
    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32).astype(dtype)
    return {"w": arr(4, 6), "b": arr(6), "s": {"stack": arr(3, 5),
                                               "k": arr(2, 3, 4)}}


def _t(tree):
    return {k: (_t(v) if isinstance(v, dict) else
                convert.tensor_from_reference(v, device="cpu"))
            for k, v in tree.items()}


@pytest.mark.parametrize("pdtype,sdtype", [
    (np.float32, "float32"), (ml_dtypes.bfloat16, "float32"),
    (ml_dtypes.bfloat16, "bfloat16")])
@pytest.mark.parametrize("clip", [1.0, 1e-3])
def test_adamw_update_matches_reference(pdtype, sdtype, clip):
    rng = np.random.default_rng(0)
    params, grads = _tree(rng, pdtype), _tree(rng, pdtype)
    cfg_kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=clip,
                  state_dtype=sdtype)
    rcfg, pcfg = ref_adamw.OptConfig(**cfg_kw), adamw.OptConfig(**cfg_kw)
    rstate = ref_adamw.init(lm_ref.to_jax(params), rcfg)
    pstate = adamw.init(_t(params), pcfg)
    rp, pp = lm_ref.to_jax(params), _t(params)
    for _ in range(3):          # the state after a step feeds the next
        rp, rstate, rm = ref_adamw.update(lm_ref.to_jax(grads), rstate, rp,
                                          rcfg)
        pp, pstate, pm = adamw.update(_t(grads), pstate, pp, pcfg)
        for (k, a), (_, b) in zip(lm_ref.leaves(rp), lm_ref.leaves(pp)):
            assert str(b.dtype).removeprefix("torch.") == str(a.dtype), k
            np.testing.assert_allclose(lm_ref.f32(b), lm_ref.f32(a),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        for part in ("m", "v"):
            for (k, a), (_, b) in zip(lm_ref.leaves(getattr(rstate, part)),
                                      lm_ref.leaves(getattr(pstate, part))):
                np.testing.assert_allclose(lm_ref.f32(b), lm_ref.f32(a),
                                           rtol=RTOL, atol=ATOL, err_msg=k)
        assert int(pstate.step) == int(rstate.step)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[name]), float(rm[name]),
                                       rtol=RTOL)


def test_decay_rule_is_ndim_above_one():
    cfg = adamw.OptConfig(lr=0.1, warmup_steps=1, weight_decay=0.5)
    params = {"vec": torch.ones(3), "mat": torch.ones(1, 3)}
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    new, _, _ = adamw.update(zeros, adamw.init(params, cfg), params, cfg)
    assert torch.equal(new["vec"], params["vec"])     # no decay on [d]
    assert (new["mat"] < 1).all()                      # decay on [1, d]


def test_mtp_layer_norms_are_not_decayed():
    """One AdamW step on the converted deepseek SMOKE tree with zero
    gradients, fp32: the unstacked MTP layer's norms ([d_model]) keep
    their values, as the reference's do, while the stacked layers'
    [count, d_model] norms decay; both packages give the same tree."""
    rc, cfg = lm_ref.configs("deepseek-v3-671b", f32=True)
    npp = lm_ref.ref_params(rc, 0)
    tp = convert.params_from_reference(npp, cfg, device="cpu")
    jp = lm_ref.to_jax(npp)
    kw = dict(lr=0.1, warmup_steps=1, weight_decay=0.5)
    rcfg, pcfg = ref_adamw.OptConfig(**kw), adamw.OptConfig(**kw)
    new, _, _ = adamw.update(_zeros(tp), adamw.init(tp, pcfg), tp, pcfg)
    want, _, _ = jax.jit(ref_adamw.update, static_argnums=3)(
        jax.tree.map(jnp.zeros_like, jp), ref_adamw.init(jp, rcfg), jp, rcfg)
    for k in ("ln1", "ln2"):
        assert torch.equal(new["mtp"]["layer"][k], tp["mtp"]["layer"][k])
        np.testing.assert_array_equal(np.asarray(want["mtp"]["layer"][k]),
                                      npp["mtp"]["layer"][k])
        stacked = new["stack1"]["slot0"][k]
        assert stacked.dim() == 2
        assert not torch.equal(stacked, tp["stack1"]["slot0"][k])
    assert torch.equal(new["mtp"]["norm"], tp["mtp"]["norm"])
    for (k, a), (_, b) in zip(lm_ref.leaves(want), lm_ref.leaves(new)):
        np.testing.assert_allclose(lm_ref.f32(b), lm_ref.f32(a), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def _zeros(tree):
    return {k: (_zeros(v) if isinstance(v, dict) else torch.zeros_like(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 5000, 10000,
                                  20000])
def test_schedule_matches_reference(step):
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=10000)
    want = ref_adamw.schedule(ref_adamw.OptConfig(**cfg), jnp.int32(step))
    got = adamw.schedule(adamw.OptConfig(**cfg),
                         torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_adamw_converges_quadratic():
    cfg = adamw.OptConfig(lr=0.1, warmup_steps=1, total_steps=100,
                          weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init(params, cfg)
    for _ in range(60):
        params, state, _ = adamw.update({"w": 2 * params["w"]}, state,
                                        params, cfg)
    assert float(params["w"].abs().max()) < 1.0


def test_grad_clip_metric():
    cfg = adamw.OptConfig(clip_norm=1e-6)
    params = {"w": torch.ones(3)}
    p2, _, m = adamw.update({"w": torch.full((3,), 100.0)},
                            adamw.init(params, cfg), params, cfg)
    assert float(m["grad_norm"]) > 100.0
    assert float((p2["w"] - params["w"]).abs().max()) < 1e-3


@pytest.mark.parametrize("size,frac,ties", [(256, 0.1, False),
                                            (100, 0.25, True),
                                            (7, 0.01, True)])
def test_topk_compress_exact(size, frac, ties):
    rng = np.random.default_rng(size)
    g = rng.standard_normal(size).astype(np.float32)
    if ties:       # equal magnitudes, both signs: the lower index wins
        g[::3] = 0.5
        g[1::7] = -0.5
    vals, idx, n = compress.topk_compress(torch.from_numpy(g), frac)
    rv, ri, rn = ref_compress.topk_compress(jnp.asarray(g), frac)
    assert n == rn
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
    dense = compress.topk_decompress(vals, idx, n, g.shape)
    np.testing.assert_array_equal(
        dense.numpy(), np.asarray(ref_compress.topk_decompress(
            rv, ri, rn, g.shape)))


@pytest.mark.parametrize("workers", [2, 3, 4])
def test_compressed_psum_matches_named_axis(workers):
    rng = np.random.default_rng(workers)
    grads = {"w": rng.standard_normal((workers, 6, 5)).astype(np.float32),
             "b": rng.standard_normal((workers, 9)).astype(np.float32)}
    resid = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in grads.items()}
    fn = jax.vmap(lambda g, r: ref_compress.compressed_psum(
        g, ref_compress.ErrorFeedback(r), "dp", 0.2), axis_name="dp")
    want_red, want_ef = fn(lm_ref.to_jax(grads), lm_ref.to_jax(resid))
    got_red, got_ef = compress.compressed_psum(
        _t(grads), compress.ErrorFeedback(_t(resid)), "dp", 0.2)
    for k in grads:
        np.testing.assert_array_equal(got_red[k].numpy(),
                                      np.asarray(want_red[k]))
        np.testing.assert_array_equal(got_ef.residual[k].numpy(),
                                      np.asarray(want_ef.residual[k]))


def test_error_feedback_starts_at_zero():
    ef = compress.init_error_feedback({"w": torch.zeros(8, dtype=torch.bfloat16)})
    assert ef.residual["w"].dtype == torch.float32
    assert float(ef.residual["w"].sum()) == 0.0


@pytest.mark.parametrize("seed,shape", [(0, (128,)), (5, (7, 9)),
                                        (2**20, (3, 4, 5))])
def test_int8_quantize_exact(seed, shape):
    key = jax.random.key(seed)
    g = np.array(jax.random.normal(jax.random.fold_in(key, 1), shape))
    q, scale = compress.int8_quantize(torch.from_numpy(g), port_key(key))
    rq, rscale = ref_compress.int8_quantize(jnp.asarray(g), key)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(scale) == float(rscale)
    back = compress.int8_dequantize(q, scale)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref_compress.int8_dequantize(rq, rscale)))
