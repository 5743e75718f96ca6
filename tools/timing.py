"""CUDA-event timing shared by ``chip_smoke.py`` and the ``tools/time_*``
scripts."""
from __future__ import annotations

import numpy as np
import torch

SPIN_CYCLES = 2_000_000        # ~1 ms at 1.98 GHz: longer than the host
                               # takes to queue one kernel wrapper call


def median_ms(fn, reps: int, setup=None, hide_host=False) -> float:
    """Median CUDA-event ms of ``fn``; ``setup`` (untimed) runs before
    each call, to restore what an in-place kernel changed.  With
    ``hide_host`` a spin kernel queued before the start event keeps the
    card busy while the host queues ``fn``, so the span holds its device
    work alone and not the host's time to reach the launch (which a
    kernel of a few microseconds would otherwise be timed by)."""
    if setup:
        setup()
    fn()                                            # warm-up
    times = []
    for _ in range(reps):
        if setup:
            setup()
        if hide_host:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))
