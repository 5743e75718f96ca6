"""The port's RG-LRU block (``repro_torch.models.rglru``) against the
reference's ``repro.models.rglru`` on the recurrentgemma SMOKE width,
the reference's init carried across with its decay ``lam`` and conv bias
redrawn from a numpy seed: the log-depth scan against
``lax.associative_scan`` over S = 1, 7, 16, 33; the block in its three
branches (a chunk with no cache, a chunk that carries a state, the
one-token decode with its rolling conv window), fp32 at rtol 1e-4, atol
1e-5 and bf16 at 0.05, with the new caches; the fp32 gradients; and the
depthwise conv the port shares with the SSD block, equal in bf16."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

from repro.models import rglru as ref_rglru  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import rglru, ssm  # noqa: E402
from repro_torch.models.common import silu  # noqa: E402
from tests import lm_ref  # noqa: E402
from tests.test_torch_ref import partitionable  # noqa: E402,F401

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=0.05, atol=0.05)
SEQS = [1, 7, 16, 33]


def _t(a):
    return convert.tensor_from_reference(np.asarray(a), device="cpu")


def _setup(f32, seed=0, b=2, s=8):
    rc, cfg = lm_ref.configs("recurrentgemma-2b", f32)
    params, _ = ref_rglru.init_rglru(jax.random.key(seed), rc)
    rng = np.random.default_rng(seed)
    npp = {k: np.asarray(v) for k, v in params.items()}
    npp["lam"] = (npp["lam"] + 0.1 * rng.standard_normal(
        npp["lam"].shape)).astype(np.float32)
    npp["conv_b"] = (0.1 * rng.standard_normal(npp["conv_b"].shape)).astype(
        npp["conv_b"].dtype)
    dt = np.float32 if f32 else ml_dtypes.bfloat16
    x = rng.standard_normal((b, s, rc.d_model)).astype(dt)
    return (rc, {k: jnp.asarray(v) for k, v in npp.items()}, jnp.asarray(x),
            cfg, {k: _t(v) for k, v in npp.items()}, _t(x), rng, dt)


def _caches(rc, rng, b, dt):
    """A reference cache with a random conv window and state, and the
    port's copy."""
    w = rc.lru_width or rc.d_model
    c = ref_rglru.RGLRUCache(
        conv=jnp.asarray(rng.standard_normal(
            (b, rc.conv_width - 1, w)).astype(dt)),
        state=jnp.asarray(rng.standard_normal((b, w)).astype(np.float32)),
        length=jnp.asarray(5, jnp.int32))
    return c, convert.caches_from_reference(jax.tree.map(np.asarray, c),
                                            device="cpu")


def _same_cache(got, want, tol):
    np.testing.assert_allclose(lm_ref.f32(got.conv), lm_ref.f32(want.conv),
                               **tol)
    assert got.conv.dtype == _t(np.asarray(want.conv)).dtype
    assert got.state.dtype == torch.float32
    np.testing.assert_allclose(got.state.numpy(), np.asarray(want.state),
                               **tol)
    assert int(got.length) == int(want.length)


@pytest.mark.parametrize("s", SEQS)
def test_scan_matches_associative_scan(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.3, 1.0, (2, s, 5)).astype(np.float32)
    b = rng.standard_normal((2, s, 5)).astype(np.float32)
    wa, wb = lax.associative_scan(
        lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1]),
        (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ga, gb = rglru.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **F32_TOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **F32_TOL)


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("f32", [True, False])
def test_chunk_without_cache(s, f32):
    rc, jp, jx, cfg, tp, tx, _, _ = _setup(f32, s=s)
    want, wc = ref_rglru.rglru_block(jp, jx, rc, {})
    got, gc = rglru.rglru_block(tp, tx, cfg, {})
    assert wc is None and gc is None and got.dtype == tx.dtype
    np.testing.assert_allclose(lm_ref.f32(got), lm_ref.f32(want),
                               **(F32_TOL if f32 else BF16_TOL))


@pytest.mark.parametrize("s", [3, 7, 16])
@pytest.mark.parametrize("f32", [True, False])
def test_chunk_carries_a_state(s, f32):
    """``gated[:, 0] += a[:, 0] * state``, the conv tail from the chunk's
    last k - 1 inputs."""
    rc, jp, jx, cfg, tp, tx, rng, dt = _setup(f32, s=s)
    jc, tc = _caches(rc, rng, 2, dt)
    want, wc = ref_rglru.rglru_block(jp, jx, rc, {}, jc)
    got, gc = rglru.rglru_block(tp, tx, cfg, {}, tc)
    tol = F32_TOL if f32 else BF16_TOL
    np.testing.assert_allclose(lm_ref.f32(got), lm_ref.f32(want), **tol)
    _same_cache(gc, wc, tol)


@pytest.mark.parametrize("f32", [True, False])
def test_one_token_decode(f32):
    """Three decode steps through the rolling conv window."""
    rc, jp, _, cfg, tp, _, rng, dt = _setup(f32, s=1)
    jc, tc = _caches(rc, rng, 2, dt)
    tol = F32_TOL if f32 else BF16_TOL
    for _ in range(3):
        x = rng.standard_normal((2, 1, rc.d_model)).astype(dt)
        want, jc = ref_rglru.rglru_block(jp, jnp.asarray(x), rc, {}, jc)
        got, tc = rglru.rglru_block(tp, _t(x), cfg, {}, tc)
        np.testing.assert_allclose(lm_ref.f32(got), lm_ref.f32(want), **tol)
        _same_cache(tc, jc, tol)


def test_init_cache_matches_reference():
    rc, cfg = lm_ref.configs("recurrentgemma-2b")
    want = ref_rglru.init_rglru_cache(rc, 3, jnp.bfloat16)
    got = rglru.init_rglru_cache(cfg, 3, torch.bfloat16, "cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        assert not g.float().any()


def test_grads_match_reference():
    """fp32: the gradients of sum(out * r) with respect to every
    parameter and to x, through the log-depth scan."""
    rc, jp, jx, cfg, tp, tx, rng, _ = _setup(True, s=16)
    r = rng.standard_normal(jx.shape).astype(np.float32)
    jgp, jgx = jax.grad(lambda p, x: jnp.sum(
        ref_rglru.rglru_block(p, x, rc, {})[0] * r), argnums=(0, 1))(jp, jx)
    for t in tp.values():
        t.requires_grad_(True)
    tx.requires_grad_(True)
    (rglru.rglru_block(tp, tx, cfg, {})[0] * torch.from_numpy(r)).sum(
        ).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **F32_TOL)
    for k in sorted(jgp):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]),
                                   **F32_TOL, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depthwise_conv_is_the_ssd_conv(dtype):
    """The reference's ``conv_general_dilated`` with
    ``feature_group_count = W`` and weights [k, 1, W], plus the bias
    through silu, is ``ssm._causal_conv``; the decode's window einsum is
    ``ssm._taps``.  bf16: the same bits; fp32: the summation order."""
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(4)
    xw = rng.standard_normal((2, 17, 64)).astype(dt)
    w = (0.5 * rng.standard_normal((4, 64))).astype(dt)
    bias = (0.1 * rng.standard_normal(64)).astype(dt)
    pad = jnp.pad(jnp.asarray(xw), ((0, 0), (3, 0), (0, 0)))
    want = jax.nn.silu(lax.conv_general_dilated(
        pad, jnp.asarray(w)[:, None, :], (1,), "VALID",
        dimension_numbers=("NWC", "WIO", "NWC"), feature_group_count=64)
        + jnp.asarray(bias))
    got = ssm._causal_conv(_t(xw), _t(w), _t(bias))
    win = rng.standard_normal((2, 4, 64)).astype(dt)
    want_dec = jax.nn.silu(jnp.einsum("bkw,kw->bw", jnp.asarray(win),
                                      jnp.asarray(w)) + jnp.asarray(bias))
    got_dec = silu(ssm._taps(_t(win), _t(w)) + _t(bias))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(lm_ref.f32(got), lm_ref.f32(want))
        np.testing.assert_array_equal(lm_ref.f32(got_dec),
                                      lm_ref.f32(want_dec))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        np.testing.assert_allclose(got_dec.numpy(), np.asarray(want_dec),
                                   **F32_TOL)


def test_state_stays_fp32_in_bf16():
    rc, jp, jx, cfg, tp, tx, rng, dt = _setup(False, s=7)
    _, tc = _caches(rc, rng, 2, dt)
    _, gc = rglru.rglru_block(tp, tx, cfg, {}, tc)
    assert gc.state.dtype == torch.float32
    assert gc.conv.dtype == torch.bfloat16
