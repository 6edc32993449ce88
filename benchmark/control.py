#!/usr/bin/env python3
"""Readings for the limits of a cell's check, several seeds in one
process: the program as configured (sound), or the program with the
control's change (`CONTROL` of the configuration's reference module),
whose proofs the reference has to refuse.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control]

One JSON line a seed: the seed, the mode, correct, attempted and the
numbers compared. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import load  # noqa: E402
from benchmark.run import run_cell  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args(argv)
    config = load.data("cells", args.workload)["config"]
    patch = load.module("reference", config).CONTROL if args.control \
        else None
    for seed in args.seeds:
        result, reasons = run_cell(args.workload, seed, args.seconds, False,
                                   program_patch=patch)
        print(json.dumps({
            "seed": seed, "mode": "control" if args.control else "sound",
            "correct": result["correct"], "attempted": result["attempted"],
            "checks": result["checks"], "first_reason": reasons[0]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
