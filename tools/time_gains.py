#!/usr/bin/env python3
"""Time ``bucket_gains`` (row 9 of PERF.md's kernel table) on one NVIDIA
GPU.

    python3 tools/time_gains.py [--src DIR] [--label NAME] [--reps N]

One candidate row against B bucket covers at the receiver's shape
(B = 63 buckets of W = 4,096 words, ``chip_smoke.py``'s
``serve_timings``) and at a few others (one bucket of a long row, many
buckets, a row four bytes off its alignment).  For each shape it prints
the device span (``ms``: a spin kernel hides the host's time to reach
the launch, ``tools/timing.py``), the wrapper's time (``wrapper_ms``:
the same CUDA-event span with the host's path to the launch in it), the
plain version's, the byte bound and a digest of the gains: runs of two
versions on the same inputs must print the same digests.  ``--src``
names the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so two versions can be compared on one machine in
one run: run them alternately (A, B, B, A).  ``--layouts`` also times
the launch with its cluster size fixed at 1, 2, 4 and 8 blocks a
bucket, each a build of ``csrc/bucket_gains.cu`` with
``-DGAINS_CLUSTER`` (:func:`layout_libraries`), its gains held to the
plain version's.  Prints the card line, then one JSON line per shape
(and layout).  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.timing import median_ms  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak bandwidth
# (B, W, offset in words of the row and covers from a 16-byte boundary)
SHAPES = ((63, 4096, 0), (1, 65536, 0), (200, 4096, 0), (63, 4096, 1),
          (63, 4097, 0))


CLUSTERS = (1, 2, 4, 8)


def layout_libraries() -> dict:
    """{S: ``csrc/bucket_gains.cu`` of the imported ``repro_torch`` built
    with ``-DGAINS_CLUSTER=S``}, one ``nvcc`` each, all started
    together, into the build directory."""
    from repro_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for s in CLUSTERS:
        out = build.BUILD_DIR / f"libbucket_gains-cluster{s}.so"
        cmd = [build._nvcc(), *build.FLAGS, f"-DGAINS_CLUSTER={s}", "-I",
               str(build.CSRC), "-o", str(out),
               str(build.CSRC / "bucket_gains.cu")]
        jobs[s] = out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
    libs = {}
    for s, (out, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for cluster {s}:\n{log}")
        f = ctypes.CDLL(str(out)).bucket_gains
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        libs[s] = f
    return libs


def time_shape(bucket, libs, gen, b, w, off, args, dev) -> None:
    """One shape: the wrapper's kernel (device span and wrapper time), the
    plain version, and each layout library's launch."""
    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             dtype=torch.int32).to(dev)
    row = (words(w + off) & words(w + off))[off:]
    covers = (words(b, w + off) & words(b, w + off))[:, off:].contiguous()
    got = bucket.bucket_gains(row, covers)
    if not torch.equal(got, bucket.bucket_gains_plain(row, covers)):
        raise AssertionError(f"bucket_gains != plain at B={b}, W={w}")
    print(json.dumps(dict(
        label=args.label, B=b, W=w, offset_words=off,
        ms=median_ms(lambda: bucket.bucket_gains(row, covers), args.reps,
                     hide_host=True),
        wrapper_ms=median_ms(lambda: bucket.bucket_gains(row, covers),
                             args.reps),
        plain_ms=median_ms(lambda: bucket.bucket_gains_plain(row, covers),
                           10),
        bound_ms=4 * (b * w + w + b) / HBM_BYTES_PER_S * 1e3,
        digest=hashlib.sha256(got.cpu().numpy().tobytes()
                              ).hexdigest()[:16])), flush=True)
    out = torch.empty((b,), dtype=torch.int32, device=dev)
    for s, f in libs.items():
        launch = functools.partial(launch_layout, f, s, row, covers, out)
        launch()
        if not torch.equal(out, got):
            raise AssertionError(f"cluster {s} != plain at B={b}, W={w}")
        print(json.dumps(dict(
            label=args.label, B=b, W=w, offset_words=off, cluster=s,
            ms=median_ms(launch, args.reps, hide_host=True))), flush=True)


def launch_layout(f, s, row, covers, out) -> None:
    b, w = covers.shape
    err = f(row.data_ptr(), covers.data_ptr(), out.data_ptr(), b, w,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cluster {s}: error {err}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--layouts", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_gains: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import bucket

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = layout_libraries() if args.layouts else {}
    gen = torch.Generator().manual_seed(13)
    for b, w, off in SHAPES:
        time_shape(bucket, libs, gen, b, w, off, args, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
