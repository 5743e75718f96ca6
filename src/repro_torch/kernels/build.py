"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded through ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries are built at first use
into ``_build/`` next to this file (listed in ``.gitignore``), named by
a digest of the sources and flags, so a changed source rebuilds and an
unchanged one loads.  :func:`build` starts one ``nvcc`` per source, all
at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
LIBS = ("rrr_expand", "coin_pack", "greedy_pick", "bucket_insert",
        "coverage", "topk_gain", "lazy_greedy", "bucket_gains")
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda/bin): the CUDA kernels are "
                           "built on the machine with the card")
    return path


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=LIBS) -> float:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` each, all started together.  Returns the wall seconds;
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = BUILD_DIR / f"{name}.log"
        cmd = [_nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        with open(log, "w") as fh:
            proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, out, log))
    failed = []
    for name, proc, tmp, out, log in jobs:
        if proc.wait() != 0:
            failed.append(f"--- {name} ---\n{log.read_text()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the last build of ``name`` in this directory."""
    log = BUILD_DIR / f"{name}.log"
    return log.read_text() if log.exists() else ""


def function(lib: str, fn: str, argtypes,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry point ``fn`` of library ``lib``, built on first use."""
    if lib not in _loaded:
        build([lib])
        _loaded[lib] = ctypes.CDLL(str(lib_path(lib)))
    f = getattr(_loaded[lib], fn)
    f.argtypes = list(argtypes)
    f.restype = restype
    return f
