"""End-to-end training driver — twin of ``repro.launch.train``.

Runs a training loop on one device with the deterministic data
pipeline, checkpointing, the fault-tolerant supervisor and the
straggler monitor; ``--coreset`` picks each step's batch from a pool of
twice as many candidates with the streaming max-k-cover (the paper's
technique at the data layer; on the card through the fused receiver).

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
      --smoke --steps 20 --batch 8 --seq 128 --ckpt /tmp/ck --device cpu

Same flags and ``[train]`` lines as the reference, plus ``--device``
(default ``cuda``) and a closing ``[train] timing`` line: the median
step's wall seconds, tokens per second and the device's peak memory.
Every ``--arch`` runs: the encoder-decoder's batches carry stub frame
embeddings, the VLM's stub patch embeddings.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import prng, resolve_device
from repro_torch.data.pipeline import CoresetSelector, DataConfig, TokenPipeline
from repro_torch.models import model as model_lib
from repro_torch.models.common import generator
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (RunSupervisor, StragglerMonitor,
                                                 SupervisorConfig)
from repro_torch.tree import tree_leaves


def make_data_fn(cfg, batch: int, seq: int, seed: int, coreset: bool, dev):
    """The launcher's batches: ``data_fn(step)`` -> {"tokens" [batch,
    seq + 1] (+ "frames" [batch, seq, d_model] for the encoder-decoder,
    "patches" [batch, num_patches, d_model] for the VLM)}.  With
    ``coreset``, a pool of 2 x ``batch`` pipeline rows goes through the
    streaming max-cover and the picked rows (padded with unpicked ones)
    are the batch.

    The frames and patches stand in for a modality frontend, as the
    reference's do: standard normals in bf16, drawn on ``dev`` from a
    torch generator seeded with the bits of the step's key
    ``fold_in(key(seed), step)`` (the reference draws them with
    ``jax.random.normal`` under that key, so the values differ)."""
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch, seed=seed),
                         device=dev)
    selector = CoresetSelector(universe=1024, device=dev) if coreset else None

    def data_fn(step):
        if selector is not None:
            # pool of 2x candidates -> streaming max-cover -> top half
            pool = pipe.batch(step * 2, extra_token=True).cpu().numpy()
            pool2 = pipe.batch(step * 2 + 1, extra_token=True).cpu().numpy()
            docs = np.concatenate([pool, pool2])
            sel, _cov = selector.select(docs, batch)
            pad = [i for i in range(len(docs)) if i not in set(sel.tolist())]
            idx = list(sel[:batch])
            idx += pad[: batch - len(idx)]
            tokens = torch.from_numpy(
                docs[np.asarray(idx, dtype=np.int64)]).to(dev)
        else:
            tokens = pipe.batch(step)
        out = {"tokens": tokens}
        k = prng.key(seed).fold_in(step)

        def normals(shape):
            return torch.randn(shape, generator=generator(
                (k.k0 << 32) | k.k1, dev), device=dev,
                dtype=torch.float32).to(torch.bfloat16)
        if cfg.is_encoder_decoder:
            out["frames"] = normals((batch, seq, cfg.d_model))
        if cfg.family == "vlm":
            out["patches"] = normals((batch, cfg.num_patches, cfg.d_model))
        return out

    return data_fn


def main(argv=None, report: dict | None = None):
    """Parse ``argv`` and train; returns 0.  ``report``, if given, gets
    the run's figures and states: ``params``, ``restored_step`` (-1: none),
    ``restored`` (the state as restored), ``state`` and ``final_step``
    at the end, ``losses``, ``step_seconds`` (each step's wall seconds,
    its data included), ``data_seconds`` and ``peak_bytes``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--coreset", action="store_true",
                    help="GreediRIS streaming coreset selection on each "
                         "candidate batch pool (the paper's technique at "
                         "the data layer)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    report = {} if report is None else report

    cfg = get_config(args.arch, smoke=args.smoke)
    opt_cfg = adamw.OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10,
                                                           1),
                              total_steps=args.steps)
    bundle = model_lib.build(cfg, opt_cfg, sharded=False, device=dev)
    state, _specs = bundle.init_state(args.seed)
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    report["params"] = n_params
    print(f"[train] {cfg.name}: {n_params:,} params")

    data_fn = make_data_fn(cfg, args.batch, args.seq, args.seed,
                           args.coreset, dev)

    step_fn = bundle.train_step(microbatches=args.microbatches)
    mon = StragglerMonitor()
    t_last = [time.time()]
    losses, step_s, data_s = [], [], []

    def timed_data(step):
        t0 = time.perf_counter()
        out = data_fn(step)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        data_s.append(time.perf_counter() - t0)
        return out

    def on_metrics(step, metrics):
        loss = float(metrics["loss"])
        now = time.time()
        step_s.append(now - t_last[0])
        straggler = mon.observe(now - t_last[0])
        t_last[0] = now
        losses.append(loss)
        print(f"[train] step {step:5d} loss {loss:.4f} "
              f"gnorm {float(metrics['grad_norm']):.3f} "
              f"lr {float(metrics['lr']):.2e}"
              + ("  [straggler]" if straggler else ""), flush=True)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    report["restored_step"] = -1
    if args.ckpt:
        store = CheckpointStore(args.ckpt)
        sup = RunSupervisor(store, SupervisorConfig(
            checkpoint_every=args.ckpt_every))
        restored, ck_step = store.restore(state)
        start = 0
        if restored is not None:
            state, start = restored, ck_step
            report["restored_step"], report["restored"] = ck_step, restored
            print(f"[train] restored checkpoint at step {start}")
        del restored
        t_last[0] = time.time()
        # the supervisor holds the only reference to the starting state,
        # so it is freed after the first step (a fresh state: one copy
        # of the parameters and moments less at the peak)
        box = [state]
        del state
        state, final = sup.run(box.pop(), step_fn, timed_data, args.steps,
                               start_step=start, on_metrics=on_metrics)
    else:
        t_last[0] = time.time()
        for step in range(args.steps):
            state, metrics = step_fn(state, timed_data(step))
            on_metrics(step, metrics)
        final = args.steps
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    report.update(state=state, final_step=final, losses=losses,
                  step_seconds=step_s, data_seconds=data_s, peak_bytes=peak)
    if step_s:
        med = statistics.median(step_s)
        print(f"[train] timing: median step {med:.4f} s "
              f"(data {statistics.median(data_s):.4f} s), "
              f"{args.batch * args.seq / med:.1f} tokens/s, peak "
              f"{'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}")
    print(f"[train] done at step {final}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
