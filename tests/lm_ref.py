"""Shared pieces of the LM scaffold's parity tests
(``tests/test_torch_{models,train,...}.py``): the ten architectures,
their configs in both packages, reference parameters with every norm and
bias drawn from a numpy seed, and batches.  Holds no tests itself."""
from __future__ import annotations

import dataclasses

import numpy as np

PORTED = ("gemma-7b", "qwen2.5-14b", "qwen2-72b", "deepseek-coder-33b",
          "llava-next-mistral-7b", "mamba2-370m", "deepseek-v3-671b",
          "qwen3-moe-235b-a22b", "recurrentgemma-2b", "seamless-m4t-large-v2")
#: the MoE architectures: their decode drops no token only when
#: capacity_factor = num_experts / experts_per_token (cap >= group)
MOE = ("deepseek-v3-671b", "qwen3-moe-235b-a22b")


def ref_init(ref_cfg):
    """The reference's init for ``ref_cfg``'s family."""
    from repro.models import encdec, transformer
    return (encdec.init_model if ref_cfg.is_encoder_decoder
            else transformer.init_model)


def port_init(cfg):
    """The port's init for ``cfg``'s family."""
    from repro_torch.models import encdec, transformer
    return (encdec.init_model if cfg.is_encoder_decoder
            else transformer.init_model)

def configs(arch: str, f32: bool = False):
    """(reference SMOKE, port SMOKE), both in fp32 when ``f32``."""
    from repro.configs import get_config as ref_get

    from repro_torch.configs import get_config
    ref, port = ref_get(arch, smoke=True), get_config(arch, smoke=True)
    if f32:
        kw = dict(param_dtype="float32", compute_dtype="float32")
        ref, port = dataclasses.replace(ref, **kw), dataclasses.replace(port,
                                                                        **kw)
    return ref, port


def ref_params(ref_cfg, seed: int) -> dict:
    """The reference's init (key ``seed``) as numpy arrays, with the
    constant leaves (``tools.time_lm.NOISE``: norms, biases, the SSD's
    decay and skip) redrawn from ``seed``."""
    import jax

    from tools.time_lm import NOISE
    params, _ = ref_init(ref_cfg)(jax.random.key(seed), ref_cfg)
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            a = np.asarray(v)
            if k in NOISE:
                mean, sd = NOISE[k]
                base = a.astype(np.float32) if mean is None else mean
                a = (base + sd * rng.standard_normal(a.shape)).astype(a.dtype)
            out[k] = a
        return out
    return walk(params)


def to_jax(tree):
    import jax.numpy as jnp
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def batch(cfg, seed: int, b: int = 2, s: int = 16, extra: int = 1) -> dict:
    """tokens int32 [b, s + extra] (and bf16 frames [b, s, d_model] for
    the encoder-decoder, bf16 patches for the VLM)."""
    import ml_dtypes
    rng = np.random.default_rng(1000 + seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s + extra),
                                  dtype=np.int32)}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(ml_dtypes.bfloat16)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(ml_dtypes.bfloat16)
    return out


def f32(x) -> np.ndarray:
    """A jax array or a torch tensor as numpy float32."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def leaves(tree, prefix=""):
    """[(path, leaf)] in sorted-key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += leaves(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out
