"""Checkpoint store with background writes, manifests and CRC checks —
twin of ``repro.checkpoint.store`` for nested dicts of torch tensors and
numpy arrays.

* ``save`` copies every leaf to host memory before it returns (a device
  tensor is copied off the card, a host one cloned), then a background
  thread serializes the copies: the writer never reads memory that the
  caller frees or overwrites afterwards;
* a step is written to ``<root>/step_<n>.tmp`` and renamed (atomic
  publish), with a MANIFEST.json holding each file's CRC32, shape,
  dtype and kind (torch or numpy); the CRC is taken of the bytes as
  they are written, and ``restore`` reads each file once, so a file
  crosses the disk once each way;
* all but the newest ``keep`` steps are deleted after each write;
* ``restore`` loads the newest intact step (or a requested one),
  verifies the CRCs, and rebuilds the tree: torch leaves as tensors on
  the device of their template leaf (on the host where the template
  leaf is no tensor) or on ``device`` when one is given, numpy leaves
  as arrays.

The ``checkpoint.write`` fault site fires before the tmp directory
exists, so an injected failure never publishes a partial step.
"""
from __future__ import annotations

import io
import json
import os
import queue
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.runtime.faults import (FaultPlan, InjectedFault,
                                        fire as _fire_fault)
from repro_torch.tree import is_record, tree_map


def _flatten(tree):
    """(leaves, treedef) of nested dicts and NamedTuples: dict keys in
    sorted order and record fields in their order, as ``jax.tree``
    orders them."""
    if isinstance(tree, dict):
        leaves, defs = [], []
        for k in sorted(tree):
            sub, d = _flatten(tree[k])
            leaves += sub
            defs.append((k, d))
        return leaves, defs
    if is_record(tree):
        leaves, defs = [], []
        for f in tree._fields:
            sub, d = _flatten(getattr(tree, f))
            leaves += sub
            defs.append((f, d))
        return leaves, {"record": type(tree).__name__, "fields": defs}
    return [tree], "*"


class _CRCWriter:
    """A file's ``write`` that also takes the CRC32 of what it writes."""

    def __init__(self, f):
        self.f, self.crc = f, 0

    def write(self, data):
        self.crc = zlib.crc32(data, self.crc)
        return self.f.write(data)


def _to_host(leaf):
    """(numpy copy, kind, dtype name) of one leaf.  Torch dtypes numpy
    lacks (bfloat16, float8) are kept as a same-width integer view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype)
        try:
            arr = t.numpy()
        except TypeError:
            arr = t.view(getattr(torch, f"int{8 * t.element_size()}")).numpy()
        return arr, "torch", name
    arr = np.array(leaf, copy=True)
    return arr, "numpy", str(arr.dtype)


class CheckpointStore:
    def __init__(self, root: str, keep: int = 3,
                 fault_plan: Optional[FaultPlan] = None):
        self.root = root
        self.keep = keep
        self.fault_plan = fault_plan
        os.makedirs(root, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._worker = threading.Thread(target=self._writer_loop,
                                        daemon=True)
        self._worker.start()
        self._error: Optional[BaseException] = None

    # ------------------------- write path -------------------------

    def save(self, step: int, tree: Any, blocking: bool = False):
        """Copy the leaves to the host and enqueue them for the writer.
        A blocking save also surfaces any writer error, this write's
        included: a recovery snapshot must not fail silently."""
        if self._error:
            raise self._error
        leaves, treedef = _flatten(tree)
        self._q.put((step, [_to_host(x) for x in leaves], treedef))
        if blocking:
            self.wait()

    def wait(self):
        self._q.join()
        if self._error:
            raise self._error

    def clear_error(self):
        """Acknowledge a surfaced writer error so the store can be
        reused (the recovery path retries the failed snapshot)."""
        err, self._error = self._error, None
        return err

    def _writer_loop(self):
        while True:
            step, leaves, treedef = self._q.get()
            try:
                self._write(step, leaves, treedef)
            except BaseException as e:  # surfaced on the next save()
                self._error = e
            finally:
                self._q.task_done()

    def _write(self, step: int, leaves, treedef):
        spec = _fire_fault(self.fault_plan, "checkpoint.write", step=step)
        if spec is not None and spec.kind == "write_fail":
            raise InjectedFault("checkpoint.write", spec.kind, spec.at)
        tmp = os.path.join(self.root, f"step_{step:09d}.tmp")
        final = os.path.join(self.root, f"step_{step:09d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "num_leaves": len(leaves),
                    "treedef": json.dumps(treedef), "files": {}}
        for i, (arr, kind, dtype) in enumerate(leaves):
            fn = f"leaf_{i:05d}.npy"
            with open(os.path.join(tmp, fn), "wb") as f:
                out = _CRCWriter(f)
                np.save(out, arr)
            crc = out.crc
            manifest["files"][fn] = {"crc32": crc, "shape": list(arr.shape),
                                     "dtype": dtype, "kind": kind}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic publish
        self._gc()

    def _gc(self):
        steps = sorted(self.list_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"),
                          ignore_errors=True)

    # ------------------------- read path -------------------------

    def list_steps(self):
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, name,
                                               "MANIFEST.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def restore(self, template: Any, step: Optional[int] = None,
                device=None):
        """Load into the structure of ``template`` and verify the CRCs.
        A torch leaf goes to ``device`` if given, else to its template
        leaf's device (the host where that leaf is no tensor).
        Returns (tree, step), or (None, -1) when the store is empty."""
        steps = self.list_steps()
        if not steps:
            return None, -1
        step = step if step is not None else steps[-1]
        d = os.path.join(self.root, f"step_{step:09d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        leaves, _ = _flatten(template)
        if manifest["num_leaves"] != len(leaves):
            raise ValueError("checkpoint/template structure mismatch: "
                             f"{manifest['num_leaves']} leaves stored, "
                             f"{len(leaves)} expected")
        out = []
        for i in range(len(leaves)):
            fn = f"leaf_{i:05d}.npy"
            path = os.path.join(d, fn)
            with open(path, "rb") as f:
                data = f.read()
            meta = manifest["files"][fn]
            if zlib.crc32(data) != meta["crc32"]:
                raise IOError(f"CRC mismatch in {path}")
            arr = np.load(io.BytesIO(data))
            del data
            if meta["kind"] == "torch":
                t = torch.from_numpy(arr)
                want = getattr(torch, meta["dtype"].removeprefix("torch."))
                to = (device if device is not None else
                      leaves[i].device if isinstance(leaves[i], torch.Tensor)
                      else "cpu")
                out.append((t.view(want) if t.dtype != want else t).to(to))
            else:
                out.append(arr)
        it = iter(out)
        return tree_map(lambda _: next(it), template), step
