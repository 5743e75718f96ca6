"""What every traffic entry shares.

A traffic file (``traffic/<mix>.json``) names its ``entry``; the entry
is ``entries/<entry>.py``, whose ``Entry`` (a subclass of
:class:`Entry` here) reads the file's parameters and drives the
program's entry points with them: it builds its state in ``setup``, runs
one unit of its work at the cell's shapes in ``warmup``, loops over
units in ``window`` until the seconds are spent (the unit running at the
end finishes), and hands what the window produced to ``counts`` (the
bounds the roofline readers take) and ``verify`` (the comparison with
the plain reference, each number beside its limit in ``LIMITS``).  With
``traced`` it passes the program's stats dicts (whose clocks synchronize
the card) and wraps its calls in the spans the metric readers read.
"""
from __future__ import annotations

import contextlib

import torch

from portbench import graph, lookup
from repro_torch.core import prng
from repro_torch.graphs import csr

M32 = 0xFFFFFFFF


def span(name: str, traced: bool):
    if not traced:
        return contextlib.nullcontext()
    return torch.profiler.record_function(f"portbench.{name}")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    """Lets the card's allocator give back what the program held."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def port_key(seed: int) -> prng.Key:
    return prng.Key((int(seed) >> 32) & M32, int(seed) & M32)


class Entry:
    # the numbers ``verify`` returns, each with its limit
    LIMITS: dict = {}

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 traced: bool):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.traced = int(seed), device, traced
        self.stats = {} if traced else None
        self.units = 0
        self.arrays = None

    def setup(self):
        self.arrays = graph.make(self.config)
        a = self.arrays
        self.g = csr.from_arrays(a.indptr, a.indices, a.probs, a.weights,
                                 device=self.device)

    def warmup(self):
        raise NotImplementedError

    def window(self, seconds: float) -> dict:
        """Units until ``seconds`` have passed -> the end-to-end
        quantities."""
        raise NotImplementedError

    def requests(self) -> tuple[int, int]:
        """(attempted, failed) in the window."""
        raise NotImplementedError

    def counts(self) -> dict:
        return {}

    def verify(self) -> dict:
        """Frees the program's state and compares what the window
        produced with the reference -> {number: value}."""
        raise NotImplementedError

    def required_kernels(self) -> list[str]:
        """Kernels a traced run must see: the traffic's ``kernels`` and
        its ``sampler_kernels`` of the configuration's model."""
        t = self.traffic
        return list(t.get("kernels", ())) + list(
            t.get("sampler_kernels", {}).get(self.config["model"], ()))


def entry_class(traffic: dict):
    return lookup.module("entries", traffic["entry"]).Entry
