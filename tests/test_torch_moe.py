"""The port's routed MoE layer (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` on the two MoE SMOKE configs (DeepSeek's
with a shared expert, Qwen3's without), the reference's init carried
across: the output and the aux loss (fp32 at rtol 1e-4, atol 1e-5; bf16
at 0.05), the router's keep mask (exact, against the reference's own
routing lines), a case built to drop most slots, several dispatch
groups, the top-k order on ties, and the fp32 gradients."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as ref_moe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from tests import lm_ref  # noqa: E402
from tests.test_torch_ref import partitionable  # noqa: E402,F401

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=0.05, atol=0.05)


def _setup(arch, f32, seed=0, b=2, s=16, **cfg_kw):
    rc, cfg = lm_ref.configs(arch, f32)
    rc, cfg = (dataclasses.replace(rc, **cfg_kw),
               dataclasses.replace(cfg, **cfg_kw))
    params, _ = ref_moe.init_moe(jax.random.key(seed), rc)
    npp = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, rc.d_model)).astype(
        np.float32 if f32 else ml_dtypes.bfloat16)
    return (rc, lm_ref.to_jax(npp), jnp.asarray(x), cfg, _conv(npp),
            convert.tensor_from_reference(x, device="cpu"))


def _conv(tree):
    return {k: (_conv(v) if isinstance(v, dict) else
                convert.tensor_from_reference(v, device="cpu"))
            for k, v in tree.items()}


def _ref_keep(p, x, cfg):
    """The reference's routing lines (``repro.models.moe.moe``, up to the
    keep mask), for the mask the reference function does not return."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    tg = min(cfg.moe_group or ref_moe.MOE_GROUP, t)
    xt = x.reshape(t // tg, tg, d)
    probs = jax.nn.softmax(
        jnp.einsum("gtd,de->gte", xt.astype(jnp.float32), p["router"]), -1)
    _, idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.float32)
    cap = max(k, int(tg * k / e * cfg.capacity_factor))
    flat = onehot.reshape(t // tg, tg * k, e)
    pos = jnp.max(jnp.cumsum(flat, axis=1) * flat - 1.0, -1).reshape(
        t // tg, tg, k)
    return np.asarray((pos < cap) & (pos >= 0)), np.asarray(idx)


def _port_keep(p, x, cfg):
    b, s, d = x.shape
    tg = min(cfg.moe_group or moe.MOE_GROUP, b * s)
    _, _, onehot, _, keep, _ = moe.route(p, x.reshape(-1, tg, d), cfg)
    return keep.numpy(), onehot.argmax(-1).numpy()


@pytest.mark.parametrize("arch", lm_ref.MOE)
@pytest.mark.parametrize("f32", [True, False])
def test_moe_output_aux_and_keep_match_reference(arch, f32):
    rc, jp, jx, cfg, tp, tx = _setup(arch, f32)
    jy, jaux = ref_moe.moe(jp, jx, rc, {})
    y, aux = moe.moe(tp, tx, cfg, {})
    assert y.dtype == tx.dtype and aux.dtype == torch.float32
    tol = F32_TOL if f32 else BF16_TOL
    np.testing.assert_allclose(lm_ref.f32(y), lm_ref.f32(jy), **tol)
    np.testing.assert_allclose(float(aux), float(jaux), **F32_TOL)
    want_keep, want_idx = _ref_keep(jp, jx, rc)
    keep, idx = _port_keep(tp, tx, cfg)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(keep, want_keep)


@pytest.mark.parametrize("arch", lm_ref.MOE)
@pytest.mark.parametrize("f32", [True, False])
def test_moe_drops_tokens_as_the_reference(arch, f32):
    """A router that sends every token to expert 0 first, at capacity
    factor 0.25 (cap = k): most first choices drop, and the dropped
    slots pass nothing through, on both packages alike."""
    rc, jp, jx, cfg, tp, tx = _setup(arch, f32, capacity_factor=0.25)
    router = np.asarray(jp["router"]).copy()
    router[:, 0] += 3.0 * np.sign(np.asarray(jx, np.float32).mean((0, 1)))
    jp = {**jp, "router": jnp.asarray(router)}
    tp = {**tp, "router": torch.from_numpy(router)}
    want_keep, _ = _ref_keep(jp, jx, rc)
    keep, _ = _port_keep(tp, tx, cfg)
    np.testing.assert_array_equal(keep, want_keep)
    assert (~keep).sum() >= keep.size // 2, "the case drops too little"
    jy, jaux = ref_moe.moe(jp, jx, rc, {})
    y, aux = moe.moe(tp, tx, cfg, {})
    tol = F32_TOL if f32 else BF16_TOL
    np.testing.assert_allclose(lm_ref.f32(y), lm_ref.f32(jy), **tol)
    np.testing.assert_allclose(float(aux), float(jaux), **F32_TOL)


@pytest.mark.parametrize("group,b,s", [(8, 2, 16), (16, 4, 8), (512, 3, 5)])
def test_moe_dispatch_groups(group, b, s):
    """Capacity per group of ``moe_group`` tokens: 4 groups, 2 groups,
    and one group of an odd token count below the default size."""
    rc, jp, jx, cfg, tp, tx = _setup("deepseek-v3-671b", True, b=b, s=s,
                                     moe_group=group)
    jy, jaux = ref_moe.moe(jp, jx, rc, {})
    y, aux = moe.moe(tp, tx, cfg, {})
    np.testing.assert_allclose(lm_ref.f32(y), lm_ref.f32(jy), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **F32_TOL)
    np.testing.assert_array_equal(_port_keep(tp, tx, cfg)[0],
                                  _ref_keep(jp, jx, rc)[0])


def test_moe_group_must_divide_tokens():
    _, _, _, cfg, tp, tx = _setup("qwen3-moe-235b-a22b", True, b=3, s=4,
                                  moe_group=8)
    with pytest.raises(AssertionError):
        moe.moe(tp, tx, cfg, {})


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_order_on_ties(k):
    """``lax.top_k``'s order: highest first, the lower index first among
    equal values."""
    probs = np.array([[0.2, 0.3, 0.2, 0.3, 0.0],
                      [0.25, 0.25, 0.25, 0.25, 0.0],
                      [0.1, 0.4, 0.4, 0.0, 0.1]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
    gv, gi = moe.top_k(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("arch", lm_ref.MOE)
def test_moe_grads_match_reference(arch):
    """fp32: the gradients of sum(y * r) + aux with respect to every
    parameter and to x."""
    rc, jp, jx, cfg, tp, tx = _setup(arch, True)
    r = np.random.default_rng(5).standard_normal(jx.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = ref_moe.moe(p, x, rc, {})
        return jnp.sum(y * r) + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    leaves = lm_ref.leaves(tp)
    for _, t in leaves:
        t.requires_grad_(True)
    tx.requires_grad_(True)
    y, aux = moe.moe(tp, tx, cfg, {})
    ((y * torch.from_numpy(r)).sum() + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **F32_TOL)
    for (name, want), (_, t) in zip(lm_ref.leaves(jgp), leaves):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   **F32_TOL, err_msg=name)
