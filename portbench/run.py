"""Runs one cell of the benchmark once and prints its result line.

    python3 portbench/run.py --workload g500_ic.imm --seed 7 \
        --seconds 51 --trace 0

Run from the root of a checkout that holds ``src/repro_torch``; it needs
``torch.cuda`` with at least the cell's chips.  The port builds its
kernels once into ``src/repro_torch/kernels/_build/`` inside the
checkout.  The last line of
standard output is the result (``harness.run``); the numbers the check
compared, each beside its limit, are the last lines of standard error.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def process_age() -> float:
    """Seconds since this process started (the kernel's clock), or since
    this file began, where /proc does not say."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(up - ticks / os.sysconf("SC_CLK_TCK"),
                   time.perf_counter() - STARTED)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - STARTED


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = time.perf_counter() - process_age()

    import torch
    from portbench import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell(args.workload, spec)
    chips = [w for w in spec["workloads"] if w["name"] == args.workload][0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < chips["chips"]:
        print(f"{args.workload} needs {chips['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", started)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in the benchmark's process: {found}", file=sys.stderr)
        return 3
    harness.report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
