"""The port's LM models (``repro_torch.models``) against the reference's
``repro.models`` on all ten SMOKE architectures, the reference's
parameters carried across with ``convert.params_from_reference``:

* fp32 variants (``param_dtype = compute_dtype = "float32"``): logits,
  loss and every gradient at rtol 1e-4, atol 1e-5 — the two differ only
  in the order XLA and torch sum in fp32;
* the bf16 SMOKEs as they are: logits and loss at rtol 0.05, atol 0.05
  (the reference's own decode-vs-forward bound), as are prefill and
  decode, and each arch's decode against its own forward (the MoE
  archs' at a capacity factor that drops no token);
* the blockwise attention over several blocks (windows, empty cache
  slots) and the chunked SSD scan over several chunks, in fp32.

MLA and the multi-token-prediction head alone: ``test_torch_mla.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import dataclasses  # noqa: E402

from repro.models import attention as ref_attn  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import (attention, encdec, model, ssm,  # noqa: E402
                                transformer)
from repro_torch.train import steps  # noqa: E402
from tests import lm_ref  # noqa: E402
from tests.test_torch_ref import partitionable  # noqa: E402,F401

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=0.05, atol=0.05)


def _both(arch, f32, seed=0, **batch_kw):
    ref_cfg, cfg = lm_ref.configs(arch, f32)
    npp = lm_ref.ref_params(ref_cfg, seed)
    nb = lm_ref.batch(ref_cfg, seed, **batch_kw)
    return (ref_cfg, lm_ref.to_jax(npp), lm_ref.to_jax(nb), cfg,
            convert.params_from_reference(npp, cfg, device="cpu"),
            convert.batch_from_reference(nb, device="cpu"))


def _forward_logits(pkg, params, cfg, batch, drop_last=True):
    """The logits of the forward over the batch's tokens (the last one
    left out when ``drop_last``) through ``pkg``'s transformer or, for
    the encoder-decoder, its encode then decode."""
    tfm, enc = pkg
    tokens = batch["tokens"][:, :-1] if drop_last else batch["tokens"]
    if cfg.is_encoder_decoder:
        return enc.decode(params, cfg, {}, tokens,
                          enc.encode(params, cfg, {}, batch["frames"]))[0]
    prefix = batch.get("patches") if cfg.family == "vlm" else None
    return tfm.forward(params, cfg, {}, tokens, prefix_embeds=prefix)[0]


REF, PORT = (ref_tfm, ref_encdec), (transformer, encdec)


@pytest.mark.parametrize("arch", lm_ref.PORTED)
def test_f32_logits_loss_and_grads(arch):
    rc, jp, jb, cfg, tp, tb = _both(arch, f32=True)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: ref_steps._loss_fn(p, rc, {}, jb), has_aux=True)(jp)
    loss, metrics, grads = steps.loss_and_grads(tp, cfg, {}, tb)
    np.testing.assert_allclose(
        lm_ref.f32(_forward_logits(PORT, tp, cfg, tb)),
        lm_ref.f32(_forward_logits(REF, jp, rc, jb)), **F32_TOL)
    np.testing.assert_allclose(float(loss), float(jloss), **F32_TOL)
    # the cross-entropy, and the MoE aux loss and the MTP loss where the
    # config has them; the loss above is their weighted sum
    assert sorted(metrics) == sorted(jmetrics)
    for name in jmetrics:
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), **F32_TOL,
                                   err_msg=name)
    want, got = lm_ref.leaves(jgrads), lm_ref.leaves(grads)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(want, got):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(lm_ref.f32(b), lm_ref.f32(a), **F32_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("arch", lm_ref.PORTED)
def test_bf16_logits_and_loss(arch):
    rc, jp, jb, cfg, tp, tb = _both(arch, f32=False)
    got = _forward_logits(PORT, tp, cfg, tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        lm_ref.f32(got), lm_ref.f32(_forward_logits(REF, jp, rc, jb)),
        **BF16_TOL)
    loss, _, grads = steps.loss_and_grads(tp, cfg, {}, tb)
    jloss, _ = ref_steps._loss_fn(jp, rc, {}, jb)
    np.testing.assert_allclose(float(loss), float(jloss), **BF16_TOL)
    for (_, g), (_, p) in zip(lm_ref.leaves(grads), lm_ref.leaves(tp)):
        assert g.dtype == p.dtype and torch.isfinite(g.float()).all()


@pytest.mark.parametrize("arch", lm_ref.PORTED)
def test_prefill_and_decode_match_reference(arch):
    """Prefill 8 tokens (after the VLM's patches; beside the
    encoder-decoder's 8 frames), then two decode steps, on both
    packages: each step's logits (the MoE archs at their published
    capacity factor)."""
    rc, jp, jb, cfg, tp, tb = _both(arch, f32=False, s=8, extra=0)
    npre = cfg.num_patches if cfg.family == "vlm" else 0
    max_len = 8 + npre + 4
    rb = ref_model.build(rc, sharded=False)
    pb = model.build(cfg, sharded=False, device="cpu")
    jlog, jcarry = rb.prefill_step(max_len=max_len)(jp, jb)
    tlog, tcarry = pb.prefill_step(max_len=max_len)(tp, tb)
    np.testing.assert_allclose(lm_ref.f32(tlog), lm_ref.f32(jlog), **BF16_TOL)
    rng = np.random.default_rng(9)
    for i in range(2):
        tok = rng.integers(0, cfg.vocab_size, (2, 1), dtype=np.int32)
        pos = 8 + npre + i
        jlog, jcarry = rb.decode_step()(jp, jcarry, jnp.asarray(tok),
                                        jnp.asarray(pos))
        tlog, tcarry = pb.decode_step()(tp, tcarry, torch.from_numpy(tok),
                                        torch.tensor(pos))
        assert tlog.shape == (2, cfg.vocab_size)
        np.testing.assert_allclose(lm_ref.f32(tlog), lm_ref.f32(jlog),
                                   **BF16_TOL)


@pytest.mark.parametrize("arch", lm_ref.PORTED)
def test_decode_matches_forward(arch):
    """Prefill 8 tokens then decode the 9th: its logits equal the port's
    own forward over 16 tokens at that position (causal).  The MoE archs
    run at capacity_factor = num_experts / experts_per_token, so that the
    capacity covers a whole group and no token drops: at the published
    1.25 the forward's 32 tokens share 10 slots an expert, where a
    one-token decode never drops one."""
    _, _, _, cfg, tp, tb = _both(arch, f32=False, s=15, extra=1)
    if arch in lm_ref.MOE:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    npre = cfg.num_patches if cfg.family == "vlm" else 0
    pb = model.build(cfg, sharded=False, device="cpu")
    full = _forward_logits(PORT, tp, cfg, tb, drop_last=False)
    _, carry = pb.prefill_step(max_len=16 + npre)(
        tp, {**tb, "tokens": tb["tokens"][:, :8]})
    logits, _ = pb.decode_step()(tp, carry, tb["tokens"][:, 8:9],
                                 torch.tensor(8 + npre))
    np.testing.assert_allclose(lm_ref.f32(logits),
                               lm_ref.f32(full[:, npre + 8]), **BF16_TOL)


@pytest.mark.parametrize("sq,skv,qc,kc,window,causal,empty", [
    (16, 16, 4, 8, 0, True, 0), (8, 24, 8, 4, 5, True, 3),
    (12, 12, 1024, 1024, 0, False, 0), (1, 32, 1024, 8, 0, True, 7)])
def test_chunked_attention_blocks(sq, skv, qc, kc, window, causal, empty):
    rng = np.random.default_rng(sq * skv + kc)
    b, h, kvh, dk, dv = 2, 4, 2, 8, 6
    q = rng.standard_normal((b, sq, h, dk)).astype(np.float32)
    k = rng.standard_normal((b, skv, kvh, dk)).astype(np.float32)
    v = rng.standard_normal((b, skv, kvh, dv)).astype(np.float32)
    q_pos = np.arange(skv - sq, skv, dtype=np.int32)
    kv_pos = np.arange(skv, dtype=np.int32)
    if empty:
        kv_pos[-empty:] = attention.EMPTY_POS
    kw = dict(causal=causal, window=window, scale=0.3, q_chunk=qc,
              kv_chunk=kc)
    want = ref_attn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos), **kw)
    got = attention.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_pos=torch.from_numpy(q_pos), kv_pos=torch.from_numpy(kv_pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("s,chunk,with_state", [(16, 4, False),
                                                (24, 8, True), (5, 64, True)])
def test_ssd_chunked_scan(s, chunk, with_state):
    rng = np.random.default_rng(s + chunk)
    b, h, p, n = 2, 3, 4, 5
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    a = rng.uniform(0.5, 4.0, h).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    st = (rng.standard_normal((b, h, p, n)).astype(np.float32)
          if with_state else None)
    wy, ws = ref_ssm._ssd_chunked(*map(jnp.asarray, (xh, dt, a, bm, cm)),
                                  chunk, None if st is None else
                                  jnp.asarray(st))
    gy, gs = ssm._ssd_chunked(*map(torch.from_numpy, (xh, dt, a, bm, cm)),
                              chunk, None if st is None else
                              torch.from_numpy(st))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **F32_TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **F32_TOL)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 11, 7)).astype(np.float32)
    w = rng.standard_normal((4, 7)).astype(np.float32)
    bias = rng.standard_normal(7).astype(np.float32)
    want = ref_ssm._causal_conv(*map(jnp.asarray, (u, w, bias)))
    got = ssm._causal_conv(*map(torch.from_numpy, (u, w, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)



