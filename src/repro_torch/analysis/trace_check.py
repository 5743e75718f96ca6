"""What a call issues, recorded as it runs (twin of
``repro/analysis/jaxpr_check.py``).

The reference traces an entry point to a jaxpr and walks its equations.
PyTorch runs eagerly, so the port records the call while it runs: a
:class:`Recorder` (a ``TorchDispatchMode``) sees every aten op the call
issues and keeps the name, dtype and shape of each output, and
``ops.launch`` notes each kernel it launches in the active recorder
(``ops.RECORDER``; with none active the hook does nothing).  A kernel is
opaque to the recorder, as a ``pallas_call`` is to a jaxpr: what it does
inside shows only in what its wrapper allocates around it.

:func:`launch_sites`, :func:`has_intermediate` and :func:`dtypes_used`
answer what the reference's functions of the same names answer, over a
recording instead of a jaxpr.  Not ported: the HLO pass
(``hlo_text``, ``collective_stats``, ``transpose_count``: one card, no
XLA program to compile), and a launch's grid and block-spec VMEM (a CUDA
launch sizes its grid at run time; the shared memory it asks for is
``kernels/smem_budget.py``'s model, checked by ``contracts.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One tensor an aten op returned."""
    op: str                    # e.g. "aten.index_select.default"
    dtype: str                 # e.g. "int32"
    shape: tuple


@dataclasses.dataclass(frozen=True)
class LaunchSite:
    """One kernel launch, and how many op outputs came before it."""
    name: str                  # a name of ops.KERNELS
    index: int


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class Recorder(TorchDispatchMode):
    """Records the ops and the launches of the calls made inside its
    ``with`` block.  Recorders nest; a launch goes to the innermost."""

    def __init__(self):
        super().__init__()
        self.ops: list[OpRecord] = []
        self.launches: list[LaunchSite] = []
        self._outer = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.ops.append(OpRecord(str(func), dtype_name(t.dtype),
                                         tuple(t.shape)))
        return out

    def note_launch(self, kernel: str) -> None:
        """Called by ``ops.launch`` after each successful launch."""
        self.launches.append(LaunchSite(kernel, len(self.ops)))

    def __enter__(self):
        self._outer, ops.RECORDER = ops.RECORDER, self
        return super().__enter__()

    def __exit__(self, *exc):
        ops.RECORDER = self._outer
        return super().__exit__(*exc)


def record(fn, *args, **kwargs):
    """(fn(*args, **kwargs), its :class:`Recorder`)."""
    with Recorder() as rec:
        out = fn(*args, **kwargs)
    return out, rec


def _as_recorder(rec) -> Recorder:
    if not isinstance(rec, Recorder):
        raise TypeError(f"expected a Recorder (from record), got "
                        f"{type(rec).__name__}: the checker reads the ops "
                        "a call issued, never a printed trace")
    return rec


def launch_sites(rec: Recorder) -> list[LaunchSite]:
    """Every kernel launch of the recorded call, in order."""
    return list(_as_recorder(rec).launches)


def launch_counts(rec: Recorder) -> dict[str, int]:
    """Launches of the recorded call by kernel name."""
    counts: dict[str, int] = {}
    for site in launch_sites(rec):
        counts[site.name] = counts.get(site.name, 0) + 1
    return counts


def has_intermediate(rec: Recorder, dtype: str,
                     shape: Sequence[int]) -> bool:
    """True iff some op of the recorded call returned a tensor of exactly
    this dtype and shape (a view counts: it is what the next op reads)."""
    want = tuple(shape)
    return any(r.dtype == dtype and r.shape == want
               for r in _as_recorder(rec).ops)


def dtypes_used(rec: Recorder) -> set[str]:
    """Every dtype an op of the recorded call returned."""
    return {r.dtype for r in _as_recorder(rec).ops}
