"""Faults planted under the timed path, and their readings at a cell's size.

    python3 -m benchmark.faults --workload <name> --seconds <s> \
        --seeds <n> [<n> ...]

Each fault wraps the port's frame step (``render.renderer.frame_step``),
which every render call of the shell runs once a frame:

- ``state_unchanged``: the step returns the frame but the state it was
  given, so TAA history, exposure and the last pose never move;
- ``half_batch``: in a call of more than one frame the second half shows
  the first half's frames again (half of the batch left out);
- ``frame_altered``: one row of cells of every frame takes another ANSI
  colour where the step produces it.

For each seed and each fault that the cell's traffic can have, in one
process on the card: a short window of the cell at its own size and load
with the fault planted, then the comparison. One JSON line a run, with
every number compared and its limit; the benchmark's own runs never run
this. There is no exchange between chips to leave out: every cell runs on
one card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys


def state_unchanged(real):
    def step(packed, cams, inputs, row, state, *a, **k):
        out, _ = real(packed, cams, inputs, row, state, *a, **k)
        return out, state
    return step


def half_batch(real):
    last = {}

    def step(packed, cams, inputs, row, state, *a, **k):
        n = cams.pos.shape[0]
        if n > 1 and row >= n // 2:
            return last["out"], state   # frame row - n/2 shown again
        out, state = real(packed, cams, inputs, row, state, *a, **k)
        last["out"] = out
        return out, state
    return step


def frame_altered(real):
    def step(*a, **k):
        out, state = real(*a, **k)
        fg = out.fg_ansi.clone()
        fg[1] = (fg[1] + 1) % 256   # one row of cells another colour
        return dataclasses.replace(out, fg_ansi=fg), state
    return step


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "frame_altered": frame_altered}


def faults_of(cell) -> list:
    """The faults a cell can have: half a batch only where calls render
    more than one frame."""
    return [f for f in FAULTS
            if f != "half_batch" or int(cell.traffic["batch"]) > 1]


@contextlib.contextmanager
def planted(name: str):
    """The port's frame step wrapped by fault ``name`` while inside."""
    from yetanotherconsolegameengine_tpu_torch.render import renderer
    real = renderer.frame_step
    renderer.frame_step = FAULTS[name](real)
    try:
        yield
    finally:
        renderer.frame_step = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from . import spec
    from .run import ROOT, pin_to_one_core, run_cell, set_cache_dirs
    set_cache_dirs(ROOT)
    pin_to_one_core()
    import torch
    if not torch.cuda.is_available():
        print("faults: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    for seed in args.seeds:
        for name in faults_of(cell):
            with planted(name):
                result, _, errors = run_cell(args.workload, seed,
                                             args.seconds, 0)
            print(json.dumps({
                "workload": args.workload, "seed": seed, "fault": name,
                "correct": result["correct"], "errors": errors[:3],
                "failed": [k for k, v in result["check"].items()
                           if v["value"] > v["limit"]],
                "numbers": {k: v["value"]
                            for k, v in result["check"].items()}}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
