"""Core algorithms: bitsets, PRNG, sampling, max-cover, IMM, cascades."""
import time

import torch


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


class StageClock:
    """Adds the wall seconds of a block to ``stats[name]``, waiting for
    the card at both ends so device work is charged where it runs.
    Does nothing when ``stats`` is None."""

    def __init__(self, stats, name: str, device):
        self.stats, self.name = stats, name
        self.device = torch.device(device)

    def __enter__(self):
        if self.stats is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.stats is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stats[self.name] = (self.stats.get(self.name, 0.0)
                                     + time.perf_counter() - self.t0)
