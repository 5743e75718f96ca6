#!/usr/bin/env python3
"""The LM scaffold on one NVIDIA GPU: phase ``lm`` of ``chip_smoke.py``.

    python3 tools/time_lm.py

Builds the kernels, then:

* ``lm smoke``: each ported architecture's SMOKE config (weights from
  the port's init under seed 0, norms, biases and the SSD's decay and
  skip drawn from a numpy seed) on the card against the CPU on the same
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
from repro_torch.models import common, model, transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

PORTED = ("gemma-7b", "qwen2.5-14b", "qwen2-72b", "deepseek-coder-33b",
          "llava-next-mistral-7b", "mamba2-370m")
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

# the leaves the init sets to constants, redrawn from a numpy seed (mean,
# sd) so that norms, biases and the SSD's decay and skip take part;
# a_log's mean is its init
NOISE = {"ln1": (0.0, 0.1), "ln2": (0.0, 0.1), "final_norm": (0.0, 0.1),
          "norm": (0.0, 0.1), "bq": (0.0, 0.1), "bk": (0.0, 0.1),
          "bv": (0.0, 0.1), "conv_b": (0.0, 0.1), "dt_bias": (0.0, 0.1),
          "d_skip": (1.0, 0.1), "a_log": (None, 0.1)}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def smoke_params(cfg, seed: int):
    """The port's init under ``seed`` on the CPU, the leaves of
    :data:`NOISE` redrawn from a numpy generator seeded with ``seed``."""
    params, _ = transformer.init_model(common.generator(seed, "cpu"), cfg)
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


def _logits(params, cfg, batch):
    prefix = batch.get("patches") if cfg.family == "vlm" else None
    return transformer.forward(params, cfg, {}, batch["tokens"][:, :-1],
                               prefix_embeds=prefix)[0]


def smoke_parity(dev) -> dict:
    """Each ported SMOKE on the card against the CPU."""
    out = {}
    for arch in PORTED:
        cfg = get_config(arch, smoke=True)
        cpu_p, cpu_b = smoke_params(cfg, 0), smoke_batch(cfg, 0)
        p, b = to(cpu_p, dev), to(cpu_b, dev)
        errs = {"logits": close(f"{arch} logits", _logits(p, cfg, b),
                                _logits(cpu_p, cfg, cpu_b), **BF16)}
        loss, _, grads = steps.loss_and_grads(p, cfg, {}, b)
        cpu_loss, _, cpu_grads = steps.loss_and_grads(cpu_p, cfg, {}, cpu_b)
        errs["loss"] = close(f"{arch} loss", loss, cpu_loss, **BF16)
        errs["grads"] = max(
            close(f"{arch} grad", g, c, **BF16) for g, c in zip(
                tree_leaves(grads),
                tree_leaves(cpu_grads)))
        # prefill 8 tokens, decode the 9th: the forward at its position
        npre = cfg.num_patches if cfg.family == "vlm" else 0
        bundle = model.build(cfg, sharded=False, device=dev)
        _, carry = bundle.prefill_step(max_len=16 + npre)(
            p, {**b, "tokens": b["tokens"][:, :8]})
        dec, _ = bundle.decode_step()(p, carry, b["tokens"][:, 8:9],
                                      torch.tensor(8 + npre))
        full = transformer.forward(p, cfg, {}, b["tokens"][:, :16],
                                   prefix_embeds=b.get("patches"))[0]
        errs["decode"] = close(f"{arch} decode", dec, full[:, npre + 8],
                               **BF16)
        out[arch] = errs
    return out


def gemma_decode(dev) -> dict:
    """gemma-7b's full CONFIG: prefill, 16 decode steps, the forward."""
    cfg = get_config("gemma-7b")
    b, s, n = DECODE["batch"], DECODE["prompt"], DECODE["steps"]
    bundle = model.build(cfg, sharded=False, device=dev)
    t0 = sync_clock()
    params, _ = transformer.init_model(common.generator(0, dev), cfg)
    init_s = sync_clock() - t0
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, s + n, b, seed=0),
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
    with torch.no_grad():
        full = transformer.forward(params, cfg, {}, tokens)[0][:, s - 1:]
        # the exact answer's stand-in: the same weights in fp32
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    compute_dtype="float32")
        exact = transformer.forward(
            tree_map(lambda t: t.float(), params), cfg32, {},
            tokens)[0][:, s - 1:]
    cmp = decode_vs_forward(torch.stack(steps_out, 1), full, exact)
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params, full, exact
    torch.cuda.empty_cache()
    return dict(params=n_params, init_s=init_s, prefill_s=t1 - t0,
                prefill_tokens=b * s, decode_s_per_step=(t2 - t1) / n,
                decode_tokens_per_s=b * n / (t2 - t1), peak_bytes=peak,
                **cmp)


def decode_vs_forward(dec, fwd, exact) -> dict:
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
        raise AssertionError(f"gemma decode: {out}")
    return out


def gemma_train(dev) -> dict:
    """gemma-7b at full width, 2 layers: 3 train steps, then one batch's
    gradients with two microbatches against one."""
    cfg = dataclasses.replace(get_config("gemma-7b"), **TRAIN_CUT)
    b, s = TRAIN["batch"], TRAIN["seq"]
    bundle = model.build(cfg, adamw.OptConfig(warmup_steps=1,
                                              total_steps=TRAIN["steps"]),
                         sharded=False, device=dev)
    state, _ = bundle.init_state(0)
    first = tree_leaves(state.params)
    before = [t.clone() for t in first]
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
        raise AssertionError(f"gemma train: losses {losses}")
    changed = sum(not torch.equal(a, b_) for a, b_ in
                  zip(before, tree_leaves(state.params)))
    if changed != len(before):
        raise AssertionError(f"gemma train: {len(before) - changed} "
                             "parameters did not change")
    del before, first
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
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    del state, g1, g2
    torch.cuda.empty_cache()
    return dict(params=n_params, cut=TRAIN_CUT, losses=losses,
                step_s=times, tokens_per_s=b * s / statistics.median(times),
                peak_bytes=peak, grads_s=t1 - t0, grads_micro2_s=t2 - t1,
                micro_rel_err=worst, micro_loss_err=loss_err)


def _launch(argv, report):
    """Run the launcher quietly; returns its printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv, report=report)
    if rc != 0:
        raise AssertionError(f"launch.train.main returned {rc}")
    return buf.getvalue().splitlines()


def mamba_train(dev) -> dict:
    """mamba2-370m's full CONFIG through the launcher, then its resume."""
    with tempfile.TemporaryDirectory() as tmp:
        args = MAMBA + ["--ckpt", tmp, "--device", str(dev)]
        ops.reset_launches()
        first = {}
        lines1 = _launch(args + ["--steps", str(MAMBA_STEPS[0])], first)
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        second = {}
        lines2 = _launch(args + ["--steps", str(MAMBA_STEPS[1])], second)
    want = f"[train] restored checkpoint at step {MAMBA_STEPS[0]}"
    if want not in lines2 or second["restored_step"] != MAMBA_STEPS[0]:
        raise AssertionError(f"mamba resume: {lines2[:3]}")
    a = tree_leaves(first["state"])
    r = tree_leaves(second["restored"])
    if len(a) != len(r) or not all(
            x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
            for x, y in zip(a, r)):
        raise AssertionError("mamba resume: restored state != saved state")
    if not launches.get("bucket_insert_stream"):
        raise AssertionError(f"mamba --coreset launched no fused receiver: "
                             f"{launches}")
    # every step trained: the supervisor skips a step that keeps failing
    for rep, n in ((first, MAMBA_STEPS[0]),
                   (second, MAMBA_STEPS[1] - MAMBA_STEPS[0])):
        if len(rep["losses"]) != n or not all(np.isfinite(rep["losses"])):
            raise AssertionError(f"mamba losses {rep['losses']} ({n} steps)")
    steady = first["step_seconds"][1:] + second["step_seconds"][1:]
    med = statistics.median(steady)
    return dict(params=first["params"], launches=launches,
                losses=first["losses"] + second["losses"],
                step_s=first["step_seconds"] + second["step_seconds"],
                median_step_s=med, tokens_per_s=8 * 256 / med,
                peak_bytes=[first["peak_bytes"], second["peak_bytes"]],
                restored_step=second["restored_step"],
                restored_leaves=len(r), timing_lines=[
                    ln for ln in lines1 + lines2 if "timing" in ln])


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


def lm_profile(dev) -> dict:
    """One gemma-7b decode step and one mamba2-370m launcher step."""
    cfg = get_config("gemma-7b")
    params, _ = transformer.init_model(common.generator(0, dev), cfg)
    bundle = model.build(cfg, sharded=False, device=dev)
    b, s = DECODE["batch"], DECODE["prompt"]
    tokens = TokenPipeline(DataConfig(cfg.vocab_size, s + 2, b, seed=0),
                           device=dev).batch(0, extra_token=False)
    _, carry = bundle.prefill_step(max_len=s + 2)(params,
                                                  {"tokens": tokens[:, :s]})
    decode = bundle.decode_step()
    pos = [torch.tensor(s + i, device=dev) for i in range(2)]
    decode(params, carry, tokens[:, s:s + 1], pos[0])       # warm-up
    out = {"gemma decode step": profile_window(
        lambda: decode(params, carry, tokens[:, s + 1:], pos[1]))}
    del params, carry
    torch.cuda.empty_cache()

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


def lm_phase(dev, card: str, emit, profile: bool = False) -> dict:
    """The four parts, each emitted as one JSON line with ``card``."""
    out = {}
    parts = [("lm smoke", smoke_parity), ("lm gemma decode", gemma_decode),
             ("lm gemma train", gemma_train), ("lm mamba train", mamba_train)]
    for part, fn in parts + ([("lm profile", lm_profile)] if profile else []):
        t0 = time.perf_counter()
        out[part] = fn(dev)
        emit(phase=part, card=card, seconds=time.perf_counter() - t0,
             **out[part])
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("time_lm: needs a CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    build.build()
    lm_phase(torch.device("cuda", 0), card,
             lambda **f: print(json.dumps(f), flush=True), profile=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
