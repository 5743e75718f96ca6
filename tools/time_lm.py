#!/usr/bin/env python3
"""The LM scaffold on one NVIDIA GPU: phase ``lm`` of ``chip_smoke.py``.

    python3 tools/time_lm.py

Builds the kernels, then:

* ``lm smoke``: the dense, VLM and SSM architectures' SMOKE configs
  (weights from the port's init under seed 0, norms, biases and the
  SSD's decay and skip drawn from a numpy seed) on the card against the
  CPU on the same
  weights: forward logits, loss and gradients at rtol 0.05, atol 0.05
  (bf16), and prefill plus one decode step against the card's forward
  at that position;
* ``lm gemma decode``: gemma-7b at its full CONFIG (28 layers, d_model
  3,072, vocab 256,000): prefill 8 x 128 pipeline tokens, then 16 decode
  steps fed the next pipeline tokens, each step's logits held to the
  forward over the same 144 tokens: no further from the forward in fp32
  (the same weights) than 1.5 times the bf16 forward is, since at 28
  layers two bf16 shapes of one product drift apart beyond the SMOKE's
  0.05 (:func:`decode_vs_forward`); the prefill's seconds, the decode's
  seconds a step and the peak device memory;
* ``lm gemma train``: gemma-7b at full width with its depth cut to 2
  layers (the full depth's fp32 AdamW state alone needs ~68 GB beside
  34 GB of bf16 weights and gradients): 3 train steps at batch 8, seq
  128 (finite loss, parameters that change, seconds a step), then the
  gradients of one batch with ``microbatches=2`` held to the full
  batch's: each leaf's largest difference at most 0.05 of its largest
  gradient;
* ``lm mamba train``: mamba2-370m at its full CONFIG through the
  launcher, ``launch.train.main`` with ``--steps 4 --batch 8 --seq 256
  --coreset --ckpt DIR --ckpt-every 2``, then again with ``--steps 6``:
  it must restore step 4, the restored state must equal the first run's
  final state bit for bit, and the coreset must have launched the fused
  receiver (``bucket_insert_stream``); the step seconds, tokens per
  second and peak device memory of both runs.

* ``lm part2 parity``: the MoE, MLA, RG-LRU and encoder-decoder SMOKEs
  (deepseek-v3, qwen3-moe, recurrentgemma, seamless) on the card against
  the CPU as ``lm smoke`` holds the six above (the MoE archs' decode at
  a capacity factor of experts / top-k, where no token drops); the MoE
  and MTP losses train on the card at this width only, since one MoE
  layer of qwen3-moe at full width needs ~110 GB to train;
* ``lm deepseek decode``: deepseek-v3-671b at full width (d_model 7,168,
  128 heads, MLA ranks 1,536 / 512, 256 routed experts + 1 shared,
  top-8, vocab 129,280, the MTP head) with its depth cut to one dense
  and one MoE layer, at capacity factor 32 so that nothing drops:
  prefill 4 x 112 pipeline tokens, 16 absorbed decode steps, held to a
  bf16 forward over the same 128 tokens (an fp32 copy of the weights
  does not fit beside them) at rtol 0.05, atol 0.05 wherever the router
  sends the token to the same experts in both shapes (a near tie may
  resolve either way: those positions are counted, and must be under
  half); the MTP logits' finiteness and the slots a prefill at the
  published capacity factor 1.25 would drop;
* ``lm recurrentgemma decode``: recurrentgemma-2b's full CONFIG (26
  layers): prefill 8 x 128, 16 decode steps, held to an fp32 forward as
  gemma's are;
* ``lm recurrentgemma train``: recurrentgemma-2b at full width cut to
  one (rglru, rglru, attn) unit: 3 train steps, finite losses, every
  leaf changed;
* ``lm seamless train``: seamless-m4t-large-v2's full CONFIG through the
  launcher with ``--coreset --batch 4 --seq 128 --ckpt DIR``, 2 steps,
  then a resume to step 3: every step trains, the resume restores the
  state bit for bit, one ``bucket_insert_stream`` launch a step.

Run alone (not from ``chip_smoke.py``), it adds ``lm profile``:
``torch.profiler`` over one gemma-7b decode step (full CONFIG) and over
one mamba2-370m launcher step (full CONFIG, its coreset data included,
after a warm-up step): the wall milliseconds, the device's busy
milliseconds (the kernels' summed self time, one stream) and share, the
kernels launched, and the ops that take the most device time.

Prints one JSON line a part, each with the card's name and power limit;
raises on any failure.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import (common, encdec, model,  # noqa: E402
                                moe, transformer)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

PORTED = ("gemma-7b", "qwen2.5-14b", "qwen2-72b", "deepseek-coder-33b",
          "llava-next-mistral-7b", "mamba2-370m")
MOE_MLA_RGLRU_ENCDEC = ("deepseek-v3-671b", "qwen3-moe-235b-a22b",
                        "recurrentgemma-2b", "seamless-m4t-large-v2")
BF16 = dict(rtol=0.05, atol=0.05)
# full-depth decode: its logits' largest error against the fp32 forward
# over that of the bf16 forward (:func:`decode_vs_forward`)
DRIFT = 1.5
# gradients of one batch, two microbatches against one: each leaf's
# largest difference over its largest gradient
MICRO_REL = 0.05
DECODE = dict(batch=8, prompt=128, steps=16)
TRAIN_CUT = dict(num_layers=2)
TRAIN = dict(batch=8, seq=128, steps=3)
MAMBA = ["--arch", "mamba2-370m", "--batch", "8", "--seq", "256",
         "--coreset", "--ckpt-every", "2"]
MAMBA_STEPS = (4, 6)
# deepseek-v3 at full width: one dense and one MoE layer, and a capacity
# factor at which no slot drops (cap = group), the published one beside
DEEPSEEK_CUT = dict(num_layers=2, first_dense_layers=1,
                    block_pattern=("mla", "mla"), capacity_factor=32.0)
DEEPSEEK_DECODE = dict(batch=4, prompt=112, steps=16)
PUBLISHED_CF = 1.25
RGEMMA_CUT = dict(num_layers=3, block_pattern=("rglru", "rglru", "attn"))
SEAMLESS = ["--arch", "seamless-m4t-large-v2", "--batch", "4", "--seq",
            "128", "--coreset", "--ckpt-every", "2"]
SEAMLESS_STEPS = (2, 3)

# the leaves the init sets to constants, redrawn from a numpy seed (mean,
# sd) so that norms, biases and the SSD's decay and skip take part;
# a_log's and lam's mean is their init
NOISE = {"ln1": (0.0, 0.1), "ln2": (0.0, 0.1), "ln3": (0.0, 0.1),
         "final_norm": (0.0, 0.1), "enc_norm": (0.0, 0.1),
         "dec_norm": (0.0, 0.1), "norm": (0.0, 0.1), "q_norm": (0.0, 0.1),
         "kv_norm": (0.0, 0.1), "bq": (0.0, 0.1), "bk": (0.0, 0.1),
         "bv": (0.0, 0.1), "conv_b": (0.0, 0.1), "dt_bias": (0.0, 0.1),
         "d_skip": (1.0, 0.1), "a_log": (None, 0.1), "lam": (None, 0.1)}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def smoke_params(cfg, seed: int):
    """The port's init under ``seed`` on the CPU, the leaves of
    :data:`NOISE` redrawn from a numpy generator seeded with ``seed``."""
    init = encdec.init_model if cfg.is_encoder_decoder else \
        transformer.init_model
    params, _ = init(common.generator(seed, "cpu"), cfg)
    rng = np.random.default_rng(seed)

    def walk(t):
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                walk(v)
            elif k in NOISE:
                mean, sd = NOISE[k]
                base = v.float().numpy() if mean is None else mean
                x = base + sd * rng.standard_normal(tuple(v.shape))
                t[k] = torch.from_numpy(np.asarray(x, np.float32)).to(v.dtype)
    walk(params)
    return params


def smoke_batch(cfg, seed: int, b: int = 2, s: int = 16) -> dict:
    rng = np.random.default_rng(1000 + seed)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s + 1), dtype=np.int32))}
    if cfg.is_encoder_decoder:
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    if cfg.family == "vlm":
        out["patches"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)).to(
            torch.bfloat16)
    return out


def to(tree, dev):
    return tree_map(lambda t: t.to(dev), tree)


def close(name: str, got, want, rtol: float, atol: float) -> float:
    """Largest |got - want|; raises unless |got - want| <= atol + rtol *
    |want| everywhere."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shape {tuple(g.shape)} != "
                             f"{tuple(w.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (g - w).abs()
    if (err > atol + rtol * w.abs()).any():
        raise AssertionError(f"{name}: {int((err > atol + rtol * w.abs()).sum())}"
                             f" values off, largest {float(err.max())}")
    return float(err.max())


def sync_clock() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def _logits(params, cfg, batch, drop_last=True):
    tokens = batch["tokens"][:, :-1] if drop_last else batch["tokens"]
    if cfg.is_encoder_decoder:
        return encdec.decode(params, cfg, {}, tokens, encdec.encode(
            params, cfg, {}, batch["frames"]))[0]
    prefix = batch.get("patches") if cfg.family == "vlm" else None
    return transformer.forward(params, cfg, {}, tokens,
                               prefix_embeds=prefix)[0]


def no_drop(cfg):
    """``cfg`` at capacity factor experts / top-k for an MoE config:
    the capacity then covers a whole group and no slot drops."""
    if not cfg.num_experts:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)


def smoke_parity(dev, archs=PORTED) -> dict:
    """Each SMOKE of ``archs`` on the card against the CPU."""
    out = {}
    for arch in archs:
        cfg = get_config(arch, smoke=True)
        cpu_p, cpu_b = smoke_params(cfg, 0), smoke_batch(cfg, 0)
        p, b = to(cpu_p, dev), to(cpu_b, dev)
        errs = {"logits": close(f"{arch} logits", _logits(p, cfg, b),
                                _logits(cpu_p, cfg, cpu_b), **BF16)}
        loss, metrics, grads = steps.loss_and_grads(p, cfg, {}, b)
        cpu_loss, cpu_metrics, cpu_grads = steps.loss_and_grads(
            cpu_p, cfg, {}, cpu_b)
        errs["loss"] = close(f"{arch} loss", loss, cpu_loss, **BF16)
        for name in sorted(set(metrics) - {"loss"}):    # aux, MTP
            errs[name] = close(f"{arch} {name}", metrics[name],
                               cpu_metrics[name], **BF16)
        errs["grads"] = max(
            close(f"{arch} grad", g, c, **BF16) for g, c in zip(
                tree_leaves(grads),
                tree_leaves(cpu_grads)))
        # prefill 8 tokens, decode the 9th: the forward at its position
        npre = cfg.num_patches if cfg.family == "vlm" else 0
        dcfg = no_drop(cfg)
        bundle = model.build(dcfg, sharded=False, device=dev)
        _, carry = bundle.prefill_step(max_len=16 + npre)(
            p, {**b, "tokens": b["tokens"][:, :8]})
        dec, _ = bundle.decode_step()(p, carry, b["tokens"][:, 8:9],
                                      torch.tensor(8 + npre))
        full = _logits(p, dcfg, {**b, "tokens": b["tokens"][:, :16]},
                       drop_last=False)
        errs["decode"] = close(f"{arch} decode", dec, full[:, npre + 8],
                               **BF16)
        out[arch] = errs
    return out


def part2_parity(dev) -> dict:
    return smoke_parity(dev, MOE_MLA_RGLRU_ENCDEC)


def _decode_run(dev, cfg, b: int, s: int, n: int, seed: int = 0):
    """Init ``cfg`` on the card, prefill ``b`` x ``s`` pipeline tokens,
    then ``n`` decode steps fed the next ones: (params, tokens [b, s+n],
    logits [b, n+1, V] of the prefill's last position and each step,
    figures)."""
    bundle = model.build(cfg, sharded=False, device=dev)
    t0 = sync_clock()
    params, _ = transformer.init_model(common.generator(seed, dev), cfg)
    init_s = sync_clock() - t0
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, s + n, b, seed=seed),
                         device=dev)
    tokens = pipe.batch(0, extra_token=False)
    prefill, decode = bundle.prefill_step(max_len=s + n), bundle.decode_step()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = sync_clock()
    logits, carry = prefill(params, {"tokens": tokens[:, :s]})
    t1 = sync_clock()
    steps_out = [logits]
    for i in range(n):
        logits, carry = decode(params, carry, tokens[:, s + i:s + i + 1],
                               torch.tensor(s + i, device=dev))
        steps_out.append(logits)
    t2 = sync_clock()
    peak = torch.cuda.max_memory_allocated(dev)
    del carry
    n_params = sum(t.numel() for t in tree_leaves(params))
    figures = dict(params=n_params, init_s=init_s, prefill_s=t1 - t0,
                   prefill_tokens=b * s, decode_s_per_step=(t2 - t1) / n,
                   decode_tokens_per_s=b * n / (t2 - t1), peak_bytes=peak)
    return params, tokens, torch.stack(steps_out, 1), figures


def _fp32_gated_decode(dev, name: str, cfg, shape: dict) -> dict:
    """``cfg``'s decode against its bf16 and its fp32 forward
    (:func:`decode_vs_forward`)."""
    b, s, n = shape["batch"], shape["prompt"], shape["steps"]
    params, tokens, dec, figures = _decode_run(dev, cfg, b, s, n)
    with torch.no_grad():
        full = transformer.forward(params, cfg, {}, tokens)[0][:, s - 1:]
        # the exact answer's stand-in: the same weights in fp32
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    compute_dtype="float32")
        exact = transformer.forward(
            tree_map(lambda t: t.float(), params), cfg32, {},
            tokens)[0][:, s - 1:]
    cmp = decode_vs_forward(dec, full, exact, name)
    del params, full, exact
    torch.cuda.empty_cache()
    return dict(**figures, **cmp)


def gemma_decode(dev) -> dict:
    """gemma-7b's full CONFIG: prefill, 16 decode steps, the forward."""
    return _fp32_gated_decode(dev, "gemma decode", get_config("gemma-7b"),
                              DECODE)


def rgemma_decode(dev) -> dict:
    """recurrentgemma-2b's full CONFIG: prefill, 16 decode steps through
    the RG-LRU states and the local-attention ring, the forward."""
    return _fp32_gated_decode(dev, "recurrentgemma decode",
                              get_config("recurrentgemma-2b"), DECODE)


def deepseek_decode(dev) -> dict:
    """deepseek-v3-671b at full width, one dense and one MoE layer:
    prefill, 16 absorbed decode steps, the bf16 forward, the MTP head,
    and the slots the published capacity factor drops.

    The gate: every logit within the bf16 bound of the forward's at each
    position whose token the router sends to the same experts in both
    shapes.  With one MoE layer, and that one last, a position's logits
    depend on its own token's routing only; a near tie between two
    experts may resolve either way under the two shapes' bf16 roundings,
    and such positions are counted, not held."""
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), **DEEPSEEK_CUT)
    b, s, n = (DEEPSEEK_DECODE[k] for k in ("batch", "prompt", "steps"))
    seen = []
    real_moe = moe.moe

    def spy(p, x, c, rules):          # the MoE layer's inputs, in order
        seen.append(x)
        return real_moe(p, x, c, rules)
    moe.moe = spy
    try:
        params, tokens, dec, figures = _decode_run(dev, cfg, b, s, n)
        with torch.no_grad():
            full, _, _, hidden = transformer.forward(
                params, cfg, {}, tokens, return_hidden=True)
    finally:
        moe.moe = real_moe
    router = {"router": params["stack1"]["slot0"]["ffn"]["router"][0]}

    def experts(x):
        """Each token's top-k experts, sorted: [B, S, k]."""
        _, _, onehot, _, _, _ = moe.route(
            router, x.reshape(1, -1, x.shape[-1]), cfg)
        return onehot.argmax(-1).reshape(*x.shape[:2], -1).sort(-1).values
    prefill_x, steps_x, fwd_x = seen[0], seen[1:1 + n], seen[1 + n]
    dec_ids = torch.cat([experts(prefill_x)[:, s - 1:]] +
                        [experts(x) for x in steps_x], dim=1)
    alike = (dec_ids == experts(fwd_x)[:, s - 1:]).all(-1)      # [B, n+1]
    # the prefill's MoE input through the router at the published factor
    pub = dataclasses.replace(cfg, capacity_factor=PUBLISHED_CF)
    tg = min(pub.moe_group or moe.MOE_GROUP, b * s)
    *_, keep, cap = moe.route(router, prefill_x.reshape(-1, tg,
                                                        cfg.d_model), pub)
    del seen, prefill_x, steps_x, fwd_x
    with torch.no_grad():
        mtp = transformer.mtp_logits(
            params, cfg, {}, hidden[:, :-1], tokens[:, 1:],
            torch.arange(tokens.shape[1] - 1, device=dev))
    mtp_finite = bool(torch.isfinite(mtp).all())
    del hidden, mtp
    fwd, d = full[:, s - 1:].float(), dec.float()
    err = (d - fwd).abs()
    off = err > BF16["atol"] + BF16["rtol"] * fwd.abs()
    out = dict(**figures, cut=DEEPSEEK_CUT,
               max_abs_err_decode=float(err.max()),
               max_abs_err_routed_alike=float(err[alike].max()),
               share_outside_bf16_tol=float(off.float().mean()),
               positions=alike.numel(),
               positions_routed_apart=int((~alike).sum()),
               positions_outside=int(off.any(-1).sum()),
               outside_where_routed_alike=int(off[alike].sum()),
               argmax_agree=float((d.argmax(-1) == fwd.argmax(-1))
                                  .float().mean()),
               mtp_logits_finite=mtp_finite,
               published_cf=PUBLISHED_CF, published_cap=cap,
               dropped_slots_published=int((~keep).sum()),
               slots=keep.numel())
    del params, full, fwd, d, dec, err
    torch.cuda.empty_cache()
    if (not torch.isfinite(torch.tensor(out["max_abs_err_decode"]))
            or out["outside_where_routed_alike"] or not mtp_finite
            or out["positions_routed_apart"] * 2 > out["positions"]):
        raise AssertionError(f"deepseek decode: {out}")
    return out


def decode_vs_forward(dec, fwd, exact, name: str = "gemma decode") -> dict:
    """Hold the prefill's and the decode steps' logits ``dec`` [B, n+1,
    V] to the bf16 forward's at the same positions ``fwd``, both against
    ``exact`` (the forward in fp32): at full depth the bf16 roundings of
    two shapes of the same product drift apart, so the gate is that the
    cached path is no further from the fp32 forward than
    :data:`DRIFT` times the bf16 forward is.  Also returns the share of
    logits outside rtol 0.05, atol 0.05 of the bf16 forward."""
    dec, fwd, exact = dec.float(), fwd.float(), exact.float()
    fwd_err = float((fwd - exact).abs().max())
    dec_err = float((dec - exact).abs().max())
    off = (dec - fwd).abs() > BF16["atol"] + BF16["rtol"] * fwd.abs()
    out = dict(max_abs_err_decode=float((dec - fwd).abs().max()),
               decode_vs_fp32=dec_err, forward_vs_fp32=fwd_err,
               share_outside_bf16_tol=float(off.float().mean()),
               argmax_agree=float((dec.argmax(-1) == fwd.argmax(-1))
                                  .float().mean()))
    if not torch.isfinite(dec).all() or dec_err > DRIFT * fwd_err:
        raise AssertionError(f"{name}: {out}")
    return out


def _train_steps(dev, name: str, cfg):
    """3 train steps of ``cfg`` at :data:`TRAIN`'s batch: finite losses,
    every leaf changed.  Returns (state, pipeline, figures)."""
    b, s = TRAIN["batch"], TRAIN["seq"]
    bundle = model.build(cfg, adamw.OptConfig(warmup_steps=1,
                                              total_steps=TRAIN["steps"]),
                         sharded=False, device=dev)
    state, _ = bundle.init_state(0)
    before = [t.clone() for t in tree_leaves(state.params)]
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, s, b, seed=0),
                         device=dev)
    step = bundle.train_step()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    for i in range(TRAIN["steps"]):
        batch = {"tokens": pipe.batch(i)}
        t0 = sync_clock()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        times.append(sync_clock() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: losses {losses}")
    changed = sum(not torch.equal(a, b_) for a, b_ in
                  zip(before, tree_leaves(state.params)))
    if changed != len(before):
        raise AssertionError(f"{name}: {len(before) - changed} "
                             "parameters did not change")
    del before
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    return state, pipe, dict(params=n_params, losses=losses, step_s=times,
                             tokens_per_s=b * s / statistics.median(times),
                             peak_bytes=peak, leaves_changed=changed)


def gemma_train(dev) -> dict:
    """gemma-7b at full width, 2 layers: 3 train steps, then one batch's
    gradients with two microbatches against one."""
    cfg = dataclasses.replace(get_config("gemma-7b"), **TRAIN_CUT)
    state, pipe, figures = _train_steps(dev, "gemma train", cfg)
    batch = {"tokens": pipe.batch(0)}
    t0 = sync_clock()
    m1, g1 = steps.accumulate_grads(state.params, cfg, {}, batch, 1)
    t1 = sync_clock()
    m2, g2 = steps.accumulate_grads(state.params, cfg, {}, batch, 2)
    t2 = sync_clock()
    worst = 0.0
    for a, c in zip(tree_leaves(g1), tree_leaves(g2)):
        scale = float(a.float().abs().max())
        rel = float((c.float() - a.float()).abs().max()) / max(scale, 1e-30)
        worst = max(worst, rel)
    if worst > MICRO_REL:
        raise AssertionError(f"gemma microbatch grads: {worst} of the "
                             "leaf's largest gradient")
    loss_err = close("gemma microbatch loss", m2["loss"], m1["loss"], **BF16)
    del state, g1, g2
    torch.cuda.empty_cache()
    return dict(**figures, cut=TRAIN_CUT, grads_s=t1 - t0,
                grads_micro2_s=t2 - t1, micro_rel_err=worst,
                micro_loss_err=loss_err)


def rgemma_train(dev) -> dict:
    """recurrentgemma-2b at full width, one (rglru, rglru, attn) unit:
    3 train steps."""
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"), **RGEMMA_CUT)
    state, _, figures = _train_steps(dev, "recurrentgemma train", cfg)
    del state
    torch.cuda.empty_cache()
    return dict(**figures, cut=RGEMMA_CUT)


def _launch(argv, report):
    """Run the launcher quietly; returns its printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv, report=report)
    if rc != 0:
        raise AssertionError(f"launch.train.main returned {rc}")
    return buf.getvalue().splitlines()


def _resumed_launch(name: str, argv, steps_: tuple, dev,
                    host_copy: bool = False) -> dict:
    """The launcher with ``argv`` to ``steps_[0]`` steps, then again to
    ``steps_[1]``: it must restore step ``steps_[0]`` bit for bit, train
    every step, and launch the fused receiver once a step.  With
    ``host_copy`` the first run's final state waits on the host while the
    second runs (a large state does not fit twice on the card)."""
    with tempfile.TemporaryDirectory() as tmp:
        args = argv + ["--ckpt", tmp, "--device", str(dev)]
        ops.reset_launches()
        first = {}
        t0 = sync_clock()
        lines1 = _launch(args + ["--steps", str(steps_[0])], first)
        t1 = sync_clock()
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        saved = tree_leaves(first.pop("state"))
        if host_copy:           # pinned: a fast copy out and back
            saved = [torch.empty(t.shape, dtype=t.dtype, device="cpu",
                                 pin_memory=True).copy_(t) for t in saved]
            torch.cuda.empty_cache()
        ops.reset_launches()
        second = {}
        t2 = sync_clock()
        lines2 = _launch(args + ["--steps", str(steps_[1])], second)
        t3 = sync_clock()
        launches2 = {k: v for k, v in ops.LAUNCHES.items() if v}
    want = f"[train] restored checkpoint at step {steps_[0]}"
    if want not in lines2 or second["restored_step"] != steps_[0]:
        raise AssertionError(f"{name} resume: {lines2[:3]}")
    r = tree_leaves(second.pop("restored"))
    if len(saved) != len(r) or not all(
            x.dtype == y.dtype and y.device == dev and
            torch.equal(x.to(dev), y) for x, y in zip(saved, r)):
        raise AssertionError(f"{name} resume: restored state != saved state")
    # every step trained: the supervisor skips a step that keeps failing
    for rep, n, got in ((first, steps_[0], launches),
                        (second, steps_[1] - steps_[0], launches2)):
        if len(rep["losses"]) != n or not all(np.isfinite(rep["losses"])):
            raise AssertionError(f"{name} losses {rep['losses']} ({n} steps)")
        if got.get("bucket_insert_stream") != n:
            raise AssertionError(f"{name} --coreset: {got} over {n} steps, "
                                 "not one fused receiver a step")
    n_restored = len(r)
    del saved, r, second["state"]
    torch.cuda.empty_cache()
    return dict(params=first["params"], launches=launches,
                launches_resumed=launches2,
                losses=first["losses"] + second["losses"],
                step_s=first["step_seconds"] + second["step_seconds"],
                data_s=first["data_seconds"] + second["data_seconds"],
                peak_bytes=[first["peak_bytes"], second["peak_bytes"]],
                run_s=[t1 - t0, t3 - t2], host_copy_s=t2 - t1,
                restored_step=second["restored_step"],
                restored_leaves=n_restored, timing_lines=[
                    ln for ln in lines1 + lines2 if "timing" in ln])


def mamba_train(dev) -> dict:
    """mamba2-370m's full CONFIG through the launcher, then its resume."""
    out = _resumed_launch("mamba", MAMBA, MAMBA_STEPS, dev)
    steady = out["step_s"][1:MAMBA_STEPS[0]] + out["step_s"][
        MAMBA_STEPS[0] + 1:]
    med = statistics.median(steady)
    return dict(out, median_step_s=med, tokens_per_s=8 * 256 / med)


def seamless_train(dev) -> dict:
    """seamless-m4t-large-v2's full CONFIG through the launcher with
    ``--coreset``, then its resume."""
    out = _resumed_launch("seamless", SEAMLESS, SEAMLESS_STEPS, dev,
                          host_copy=True)
    steady = out["step_s"][1:]
    med = statistics.median(steady)
    return dict(out, median_step_s=med, tokens_per_s=4 * 128 / med)


def profile_window(fn, top: int = 10) -> dict:
    """``fn()`` under ``torch.profiler``: wall and device-busy ms, the
    busy share, kernels launched and the ``top`` ops by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = sync_clock()
        fn()
        wall = sync_clock() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0.0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    ranked = sorted(events, key=lambda e: -dev_us(e))[:top]
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                busy_share=busy / (wall * 1e3), kernels=len(kernels),
                top=[dict(op=e.key, count=e.count, device_ms=dev_us(e) / 1e3,
                          host_ms=e.self_cpu_time_total / 1e3)
                     for e in ranked])


def _profile_decode(dev, cfg, b: int, s: int, prefill: bool = False):
    """One decode step of ``cfg`` after a prefill of ``b`` x ``s`` tokens
    and a warm-up step (with ``prefill``, the prefill again first)."""
    params, _ = transformer.init_model(common.generator(0, dev), cfg)
    bundle = model.build(cfg, sharded=False, device=dev)
    tokens = TokenPipeline(DataConfig(cfg.vocab_size, s + 2, b, seed=0),
                           device=dev).batch(0, extra_token=False)
    run_prefill = bundle.prefill_step(max_len=s + 2)
    _, carry = run_prefill(params, {"tokens": tokens[:, :s]})
    out = {}
    if prefill:
        out["prefill"] = profile_window(
            lambda: run_prefill(params, {"tokens": tokens[:, :s]}))
    decode = bundle.decode_step()
    pos = [torch.tensor(s + i, device=dev) for i in range(2)]
    decode(params, carry, tokens[:, s:s + 1], pos[0])       # warm-up
    out["decode step"] = profile_window(
        lambda: decode(params, carry, tokens[:, s + 1:], pos[1]))
    del params, carry
    torch.cuda.empty_cache()
    return out


def lm_profile(dev) -> dict:
    """One decode step of gemma-7b, of deepseek-v3 at its cut and of
    recurrentgemma-2b (its prefill too: the RG-LRU's log-depth scan),
    and one mamba2-370m launcher step."""
    out = {"gemma decode step": _profile_decode(
        dev, get_config("gemma-7b"), DECODE["batch"],
        DECODE["prompt"])["decode step"]}
    out["deepseek decode step"] = _profile_decode(
        dev, dataclasses.replace(get_config("deepseek-v3-671b"),
                                 **DEEPSEEK_CUT),
        DEEPSEEK_DECODE["batch"], DEEPSEEK_DECODE["prompt"])["decode step"]
    rg = _profile_decode(dev, get_config("recurrentgemma-2b"),
                         DECODE["batch"], DECODE["prompt"], prefill=True)
    out["recurrentgemma decode step"] = rg["decode step"]
    out["recurrentgemma prefill"] = rg["prefill"]

    cfg = get_config("mamba2-370m")
    bundle = model.build(cfg, adamw.OptConfig(warmup_steps=1, total_steps=2),
                         sharded=False, device=dev)
    state, _ = bundle.init_state(0)
    data_fn = train.make_data_fn(cfg, 8, 256, 0, True, dev)
    step = bundle.train_step()
    state, _ = step(state, data_fn(0))                      # warm-up
    holder = {}

    def one():
        t0 = sync_clock()
        batch = data_fn(1)
        holder["data_ms"] = (sync_clock() - t0) * 1e3
        holder["out"] = step(state, batch)
        float(holder["out"][1]["loss"])
    out["mamba train step"] = profile_window(one)
    out["mamba train step"]["data_ms"] = holder["data_ms"]
    del state, holder
    torch.cuda.empty_cache()
    return out


def lm_phase(dev, card: str, emit, profile: bool = False,
             only=None) -> dict:
    """The nine parts (those named in ``only``, if given), each emitted
    as one JSON line with ``card``."""
    out = {}
    torch.zeros(1, device=dev)        # the allocator's peak counts exist
    parts = [("lm smoke", smoke_parity), ("lm gemma decode", gemma_decode),
             ("lm gemma train", gemma_train), ("lm mamba train", mamba_train),
             ("lm part2 parity", part2_parity),
             ("lm deepseek decode", deepseek_decode),
             ("lm recurrentgemma decode", rgemma_decode),
             ("lm recurrentgemma train", rgemma_train),
             ("lm seamless train", seamless_train)]
    for part, fn in parts + ([("lm profile", lm_profile)] if profile else []):
        if only and part not in only:
            continue
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out[part] = fn(dev)
        seconds = time.perf_counter() - t0
        # a part that times a window of its own reports that window's peak
        out[part].setdefault("peak_bytes", torch.cuda.max_memory_allocated(dev))
        emit(phase=part, card=card, seconds=seconds, **out[part])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", nargs="*", metavar="PART",
                    help="run only these parts (e.g. 'lm seamless train')")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_lm: needs a CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    build.build()
    lm_phase(torch.device("cuda", 0), card,
             lambda **f: print(json.dumps(f), flush=True), profile=True,
             only=args.parts)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
