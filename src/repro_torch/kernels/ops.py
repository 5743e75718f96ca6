"""Dispatch and launch counters of the hand-written kernels.

Every kernel wrapper goes through :func:`on_card`: tensors on the CPU
take the kernel's plain PyTorch version, tensors on a CUDA device launch
the kernel — there is no fallback between the two.  :func:`launch`
calls the C entry point on ``torch.cuda.current_stream()``, raises if it
returns an error, and only then adds one to that kernel's count in
:data:`LAUNCHES` (so a run can show that it went through the kernels)
and notes the launch in the active :data:`RECORDER`, if any.
The ``*_batch`` counts are the query-axis launches of the sender
kernels: B queries over one shared row pool, which ``greedy_pick_batch``,
``lazy_greedy_batch`` and ``topk_gain_batch`` read once per pick for
each group of queries (``topk_gain_batch``: one pick a launch).  The
machine-axis senders count each layout apart: ``compact_rows`` (the list
of non-zero words) then ``greedy_pick_compact`` or
``lazy_greedy_compact``, or the dense sweep ``greedy_pick`` or
``lazy_greedy``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

KERNELS = ("rrr_expand_resident", "rrr_expand_streamed", "rrr_expand_ic",
           "cascade_ic", "rrr_expand_lt", "cascade_lt", "coin_pack",
           "greedy_pick", "bucket_insert", "coverage", "topk_gain",
           "lazy_greedy", "bucket_insert_stream", "bucket_gains",
           "greedy_pick_batch", "lazy_greedy_batch", "topk_gain_batch",
           "compact_rows", "greedy_pick_compact", "lazy_greedy_compact")

LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
# The recorder of ``repro_torch.analysis.trace_check`` while one is
# active: :func:`launch` notes each launch in it.  None: nothing is noted.
RECORDER = None
# Machine-axis solves on the dense layout since the counts were last
# reset that handed over to the compact picks, by dense kernel
# (``greedy_pick.hand_over``).
HANDOVERS: dict[str, int] = {"greedy_pick": 0, "lazy_greedy": 0}

# What the C entry points return besides a cudaError_t: the kernel
# does not take these inputs, and nothing was launched.
_REFUSALS = {
    -2: "the row does not fit in the block's shared memory",
    -3: "the machines cannot all be co-resident for the cooperative "
        "launch",
    -4: "more than 65535 machines for the grid",
    -5: "the cover leaves no room in the block's shared memory for a "
        "double buffer of one candidate",
    -6: "no kernel is built for this query group size",
}

PTR = ctypes.c_void_p
I64 = ctypes.c_int64


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for name in HANDOVERS:
        HANDOVERS[name] = 0


def on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version).  Mixed or other devices raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"unsupported device {dev}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Raise unless ``t`` has the dtype, the shape (None = any extent)
    and a contiguous layout the kernel takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(
            s is not None and s != e for s, e in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch(kernel: str, lib: str, fn: str, argtypes, *args) -> None:
    """Call ``fn`` of ``lib`` on the current stream and count one launch
    of ``kernel`` once the C side reports success."""
    f = build.function(lib, fn, [*argtypes, PTR])
    err = f(*args, torch.cuda.current_stream().cuda_stream)
    if err in _REFUSALS:
        raise ValueError(f"{kernel}: {_REFUSALS[err]}")
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")
    LAUNCHES[kernel] += 1
    if RECORDER is not None:
        RECORDER.note_launch(kernel)


# The reference's public kernel entry points (``repro/kernels/ops.py``),
# defined in ``kernels.public``: the kernel modules import this one, so
# the names resolve on first use.
PUBLIC = ("marginal_gain", "bucket_gains", "best_gain_index",
          "greedy_maxcover_resident", "greedy_maxcover_resident_batch",
          "greedy_maxcover_lazy", "greedy_maxcover_lazy_batch",
          "rrr_expand_step", "rrr_expand_step_resident",
          "bucket_insert_chunk", "bucket_insert_stream")


def __getattr__(name: str):
    if name in PUBLIC:
        from repro_torch.kernels import public
        return getattr(public, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
