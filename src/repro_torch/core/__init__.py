"""Core algorithms: bitsets, PRNG, sampling, max-cover, IMM, cascades."""
import contextlib
import time
from typing import Optional

import torch

SPAN_PREFIX = "repro_torch."
_NO_SPAN = contextlib.nullcontext()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU.  Asking for CUDA without a card raises; nothing here
    ever falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def span(name: str):
    """A range ``repro_torch.<name>`` on the profiler's clock while a
    profiler records (``torch.profiler.profile``), else one shared
    no-op context: one gate check, nothing entered.  A span never
    waits for the card: the device work it starts may run past its
    end, unless the block ends on a read of a device value."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


class StageClock:
    """Adds the wall seconds of a block to ``stats[name]``, waiting for
    the card at both ends so device work is charged where it runs.
    Does nothing to ``stats`` when it is None.  With a ``layer`` the
    block is also the span ``<layer>.<name less its _s>``
    (``StageClock(stats, "sample_s", dev, layer="imm")`` records
    ``repro_torch.imm.sample``), opened after the first wait and closed
    after the last, whether or not ``stats`` is given."""

    def __init__(self, stats, name: str, device,
                 layer: Optional[str] = None):
        self.stats, self.name = stats, name
        self.device = torch.device(device)
        self.span = (None if layer is None
                     else f"{layer}.{name.removesuffix('_s')}")

    def __enter__(self):
        if self.stats is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()
        self.ctx = _NO_SPAN if self.span is None else span(self.span)
        self.ctx.__enter__()

    def __exit__(self, *exc):
        try:
            if self.stats is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.stats[self.name] = (self.stats.get(self.name, 0.0)
                                         + time.perf_counter() - self.t0)
        finally:
            self.ctx.__exit__(*exc)
