"""The check's control: the reference computed one precision below the
configuration's float32 (bfloat16 probabilities, cumulative weights,
uniforms, gains and thresholds), put in the program's place, must come
out as not correct.

    python3 portbench/control.py --workload g500_ic.imm --seeds 1,2,3

For each seed it runs the program once at the cell's size (one
selection, or a short window of query batches) and prints, as JSON
lines, the check's numbers for the program (the lower readings) and for
the control (the upper readings).  What the control replaces is each
entry's own (``entries/<entry>.py``, ``Entry.control``).  The
benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    _root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(_root), str(_root / "src")]

import torch  # noqa: E402

from portbench import drive, harness  # noqa: E402


def readings(cell, seed: int, device, seconds: float = 5.0):
    """(program's numbers, control's numbers) of one seed: the cell's
    entry builds its state at the cell's size and runs its ``control``."""
    entry = drive.entry_class(cell.traffic)(cell.config, cell.traffic, seed,
                                            device, False)
    entry.setup()
    return entry.control(seconds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.Cell(args.workload, spec)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        program, control = readings(cell, seed, "cuda:0", args.seconds)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "program": program, "control": control,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
