"""DeepSeek's MLA attention and multi-token-prediction head
(``repro_torch.models.attention``, ``transformer.mtp_logits``) against
the reference's on the deepseek SMOKE width, fp32 at rtol 1e-4, atol
1e-5 and bf16 at 0.05: MLA without a cache, its prefill into the
compressed cache and its absorbed one-token decode; the MTP logits; and
the converted deepseek tree, whose MTP layer is unstacked."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as ref_attn  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from tests import lm_ref  # noqa: E402
from tests.test_torch_ref import partitionable  # noqa: E402,F401

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=0.05, atol=0.05)


def _both(arch, f32, seed=0):
    ref_cfg, cfg = lm_ref.configs(arch, f32)
    npp = lm_ref.ref_params(ref_cfg, seed)
    return (ref_cfg, lm_ref.to_jax(npp), cfg,
            convert.params_from_reference(npp, cfg, device="cpu"))


def _mla_setup(f32, seed=0):
    rc, cfg = lm_ref.configs("deepseek-v3-671b", f32)
    params, _ = ref_attn.init_mla(jax.random.key(seed), rc)
    rng = np.random.default_rng(seed)
    npp = {k: np.asarray(v) for k, v in params.items()}
    for k in ("q_norm", "kv_norm"):
        npp[k] = (0.1 * rng.standard_normal(npp[k].shape)).astype(
            npp[k].dtype)
    return (rc, cfg, {k: jnp.asarray(v) for k, v in npp.items()},
            {k: convert.tensor_from_reference(v, device="cpu")
             for k, v in npp.items()}, rng)


@pytest.mark.parametrize("f32", [True, False])
def test_mla_prefill_and_absorbed_decode_match_reference(f32):
    """MLA without a cache, then a prefill of 6 tokens into the
    compressed cache (c_kv as ``k``, k_rope as ``v``) and three absorbed
    one-token decode steps: each output and the cache after it."""
    rc, cfg, jp, tp, rng = _mla_setup(f32)
    tol = F32_TOL if f32 else BF16_TOL
    dt = np.float32 if f32 else jnp.bfloat16
    x = rng.standard_normal((2, 9, rc.d_model)).astype(dt)
    pos = np.arange(6, dtype=np.int32)
    jy, _ = ref_attn.mla_attention(jp, jnp.asarray(x[:, :6]),
                                   jnp.asarray(pos), rc, {})
    ty, tcache = attention.mla_attention(
        tp, convert.tensor_from_reference(x[:, :6], device="cpu"),
        torch.from_numpy(pos), cfg, {})
    assert tcache is None
    np.testing.assert_allclose(lm_ref.f32(ty), lm_ref.f32(jy), **tol)
    jc = ref_attn.init_cache_mla(rc, 2, 10, rc.cdtype)
    tc = attention.init_cache_mla(cfg, 2, 10, cfg.cdtype, "cpu")
    assert tuple(tc.k.shape) == jc.k.shape == (2, 10, rc.kv_lora_rank)
    assert tuple(tc.v.shape) == jc.v.shape == (2, 10, rc.qk_rope_dim)
    steps_in = [(x[:, :6], pos)] + [(x[:, i:i + 1], np.array([i], np.int32))
                                    for i in range(6, 9)]
    for xs, ps in steps_in:
        jy, jc = ref_attn.mla_attention(jp, jnp.asarray(xs), jnp.asarray(ps),
                                        rc, {}, cache=jc)
        ty, tc = attention.mla_attention(
            tp, convert.tensor_from_reference(xs, device="cpu"),
            torch.from_numpy(ps), cfg, {}, cache=tc)
        np.testing.assert_allclose(lm_ref.f32(ty), lm_ref.f32(jy), **tol)
        for name, g, w in zip(tc._fields, tc, jc):
            np.testing.assert_allclose(lm_ref.f32(g), lm_ref.f32(w), **tol,
                                       err_msg=name)


def test_mla_absorbed_decode_equals_expanded_attention():
    """fp32: the absorbed decode computes the expanded attention's
    output at the decoded position (the same formula regrouped)."""
    rc, cfg, _, tp, rng = _mla_setup(True)
    x = torch.from_numpy(rng.standard_normal((2, 7, rc.d_model)).astype(
        np.float32))
    full, _ = attention.mla_attention(tp, x, torch.arange(7), cfg, {})
    cache = attention.init_cache_mla(cfg, 2, 8, torch.float32, "cpu")
    _, cache = attention.mla_attention(tp, x[:, :6], torch.arange(6), cfg, {},
                                       cache=cache)
    step, _ = attention.mla_attention(tp, x[:, 6:], torch.tensor([6]), cfg,
                                      {}, cache=cache)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 6].numpy(),
                               **F32_TOL)


@pytest.mark.parametrize("f32", [True, False])
def test_mtp_logits_match_reference(f32):
    """DeepSeek's multi-token-prediction head on a random hidden state
    and the next tokens."""
    rc, jp, cfg, tp = _both("deepseek-v3-671b", f32)
    rng = np.random.default_rng(3)
    dt = np.float32 if f32 else jnp.bfloat16
    hidden = rng.standard_normal((2, 7, rc.d_model)).astype(dt)
    nxt = rng.integers(0, rc.vocab_size, (2, 7), dtype=np.int32)
    want = ref_tfm.mtp_logits(jp, rc, {}, jnp.asarray(hidden),
                              jnp.asarray(nxt), jnp.arange(7))
    got = transformer.mtp_logits(
        tp, cfg, {}, convert.tensor_from_reference(hidden, device="cpu"),
        torch.from_numpy(nxt), torch.arange(7))
    assert got.shape == (2, 7, cfg.vocab_size)
    np.testing.assert_allclose(lm_ref.f32(got), lm_ref.f32(want),
                               **(F32_TOL if f32 else BF16_TOL))


def test_converted_deepseek_tree_has_the_reference_paths():
    """The converted deepseek SMOKE tree: the reference's paths, shapes
    and dtypes, its mtp layer unstacked (``mtp/layer/ln1`` [d_model])
    beside the stacks' [count, d_model] norms."""
    rc, cfg = lm_ref.configs("deepseek-v3-671b")
    npp = lm_ref.ref_params(rc, 0)
    got = convert.params_from_reference(npp, cfg, device="cpu")
    want, got_l = lm_ref.leaves(npp), lm_ref.leaves(got)
    assert [k for k, _ in got_l] == [k for k, _ in want]
    for (k, a), (_, b) in zip(want, got_l):
        assert tuple(b.shape) == a.shape, k
        assert str(b.dtype).removeprefix("torch.") == str(a.dtype), k
    assert tuple(got["mtp"]["layer"]["ln1"].shape) == (cfg.d_model,)
    assert tuple(got["stack1"]["slot0"]["ln1"].shape) == (3, cfg.d_model)
    assert tuple(got["mtp"]["proj"].shape) == (2 * cfg.d_model, cfg.d_model)


def test_params_from_reference_refuses_mismatched_trees():
    rc, cfg = lm_ref.configs("deepseek-v3-671b")
    npp = lm_ref.ref_params(rc, 0)
    with pytest.raises(ValueError, match="mtp"):
        convert.params_from_reference(
            {k: v for k, v in npp.items() if k != "mtp"}, cfg, device="cpu")
    stacked = {**npp, "mtp": {**npp["mtp"], "layer": {
        **npp["mtp"]["layer"], "ln1": npp["mtp"]["layer"]["ln1"][None]}}}
    with pytest.raises(ValueError, match="unstacked"):
        convert.params_from_reference(stacked, cfg, device="cpu")
    src, scfg = lm_ref.configs("seamless-m4t-large-v2")
    enc = lm_ref.ref_params(src, 0)
    convert.params_from_reference(enc, scfg, device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        convert.params_from_reference(
            {k: v for k, v in enc.items() if k != "enc_norm"}, scfg,
            device="cpu")
    with pytest.raises(ValueError, match="stacks"):
        convert.params_from_reference(enc, lm_ref.configs("gemma-7b")[1],
                                      device="cpu")
