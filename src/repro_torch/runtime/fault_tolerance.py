"""Fault tolerance and elasticity runtime — the port's own copy of
``repro.runtime.fault_tolerance``.

* ``RunSupervisor`` — retry with backoff around a step loop; classifies
  failures (a crash or a poisoned step, non-finite loss) and restores
  from the checkpoint store (:class:`repro_torch.checkpoint.store
  .CheckpointStore`).  A step that fails ``poison_threshold`` times is
  skipped: the data of a step is a pure function of (seed, step).
* ``StragglerMonitor`` — per-step wall-time EWMA with z-score flags;
  persistent stragglers shrink the GreediRIS truncation knob alpha
  (paper §3.3.2).
* ``usable_machines`` / ``elastic_remesh`` — the machine count a
  restart can use.  On one card the machines of a round are a batch
  axis, not a mesh, so ``elastic_remesh`` returns only the count: the
  largest power of two no larger than the request, given a device to
  run on.  It raises when the device is CUDA and no card is present,
  rather than silently running elsewhere.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional


@dataclasses.dataclass
class SupervisorConfig:
    max_restarts: int = 10
    backoff_s: float = 1.0
    backoff_mult: float = 2.0
    checkpoint_every: int = 50
    poison_threshold: int = 2   # same-step failures before skipping it


class PoisonStep(RuntimeError):
    pass


class RunSupervisor:
    def __init__(self, store, cfg: Optional[SupervisorConfig] = None, *,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 monitor: Optional["StragglerMonitor"] = None):
        """``sleep_fn``/``clock`` are injectable so fault tests drive
        the backoff schedule without real sleeps; ``monitor`` (a
        :class:`StragglerMonitor`) observes each successful step's
        wall time."""
        self.store = store
        self.cfg = cfg if cfg is not None else SupervisorConfig()
        self.sleep_fn = sleep_fn
        self.clock = clock
        self.monitor = monitor
        self.failures_at: dict[int, int] = {}
        self.restarts = 0

    def run(self, state, step_fn: Callable, data_fn: Callable,
            num_steps: int, start_step: int = 0,
            on_metrics: Optional[Callable] = None):
        """Drive ``step_fn(state, batch)`` with checkpoint/restart.

        ``step_fn`` raises on failure; a non-finite loss raises
        :class:`PoisonStep` here.  Returns ``(state, completed_step)``.
        """
        step = start_step
        skip: set[int] = set()
        backoff = self.cfg.backoff_s
        while step < num_steps:
            try:
                if step in skip:
                    step += 1
                    continue
                t0 = self.clock()
                batch = data_fn(step)
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise PoisonStep(f"non-finite loss at step {step}")
                if self.monitor is not None:
                    self.monitor.observe(self.clock() - t0)
                if on_metrics:
                    on_metrics(step, metrics)
                if (step + 1) % self.cfg.checkpoint_every == 0:
                    self.store.save(step + 1, state)
                # A completed step clears its failure history: a
                # transient flake much later starts the poison count
                # from scratch.
                self.failures_at.pop(step, None)
                step += 1
                backoff = self.cfg.backoff_s
            except Exception:  # noqa: BLE001 — supervisor boundary
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                self.failures_at[step] = self.failures_at.get(step, 0) + 1
                if self.failures_at[step] >= self.cfg.poison_threshold:
                    skip.add(step)   # data-dependent poison: skip batch
                self.sleep_fn(min(backoff, 30.0))
                backoff *= self.cfg.backoff_mult
                restored, ck_step = self.store.restore(state)
                if restored is not None:
                    state = restored
                    step = max(ck_step, 0)
        self.store.wait()
        return state, step


class StragglerMonitor:
    """EWMA step-time monitor with z-score flagging."""

    def __init__(self, alpha: float = 0.1, flag_sigma: float = 3.0):
        self.alpha = alpha
        self.flag_sigma = flag_sigma
        self.mean = None
        self.var = 0.0
        self.flags = 0

    def observe(self, step_time_s: float) -> bool:
        """Returns True when the step is a straggler outlier."""
        if self.mean is None:
            self.mean = step_time_s
            return False
        delta = step_time_s - self.mean
        # variance floor (5% of mean): perfectly regular step times
        # must still flag a genuine outlier
        std = max(math.sqrt(self.var), 0.05 * abs(self.mean), 1e-9)
        is_straggler = delta > self.flag_sigma * std
        self.mean += self.alpha * delta
        self.var = (1 - self.alpha) * (self.var +
                                       self.alpha * delta * delta)
        self.flags += int(is_straggler)
        return is_straggler

    def suggest_alpha(self, current_alpha: float) -> float:
        """Paper §3.3.2: under persistent stragglers, shrink the
        truncation fraction to cut receiver-side load."""
        if self.flags >= 3:
            return max(current_alpha / 2.0, 1.0 / 64.0)
        return current_alpha


def usable_machines(requested: int, available: int) -> int:
    """Largest power-of-two machine count <= min(requested, available)
    (the round's all_to_all tiling needs a power of two).  Pure, so the
    non-power-of-two and exhaustion cases are testable without a
    device."""
    if requested < 1:
        raise ValueError(
            f"requested machine count must be >= 1, got {requested}")
    if available < 1:
        raise RuntimeError(
            "no devices available to remesh onto (the device count is "
            "0) — an elastic restart needs at least one device; check "
            "the driver and the visible devices instead of silently "
            "running single-machine")
    m = min(requested, available)
    return 1 << (m.bit_length() - 1)


def elastic_remesh(requested_machines: int, device="cuda") -> int:
    """The machine count a restart on ``device`` can use: the largest
    power of two <= ``requested_machines``.  The machines are a batch
    axis of one device, so any count fits once a device is present;
    raises when ``device`` is CUDA and no card is present."""
    import torch
    dev = torch.device(device)
    present = dev.type != "cuda" or torch.cuda.device_count() > 0
    return usable_machines(requested_machines,
                           requested_machines if present else 0)
