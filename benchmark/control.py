"""Readings that the limits of ``checks/<workload>.json`` are set from.

    python3 -m benchmark.control --workload <name> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed, in one process on the card: a short window of the cell at
its own size and load, then the comparison of the kept calls, twice: the
program's numbers (the lower readings), and the numbers of the reference
computed in bfloat16 put in the program's place (the control: float32 is
what the configuration states, bfloat16 the nearest precision below). One
JSON line a seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="run the control on this many of the seeds, the "
                         "first; the rest give the program's readings only")
    args = ap.parse_args(argv)
    from .run import ROOT, pin_to_one_core, run_cell, set_cache_dirs
    set_cache_dirs(ROOT)
    pin_to_one_core()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for i, seed in enumerate(args.seeds):
        control = i < args.control_seeds
        result, _, errors = run_cell(args.workload, seed, args.seconds, 0,
                                     control=control)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": result["correct"], "errors": errors[:3],
            "program": {k: v["value"] for k, v in result["check"].items()},
            "control": result.get("control")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
