"""The voxel DDA kernel's design steps against the kernel they replaced,
timed in one process on one card.

    git show <commit>:yetanotherconsolegameengine_tpu_torch/ops/csrc/dda_kernel.cu \
        > build/dda_ladder/parent_dda_kernel.cu
    python3 -m yetanotherconsolegameengine_tpu_torch.tools.dda_ladder \
        --parent build/dda_ladder/parent_dda_kernel.cu [--reps 20]

Run from the root of the checkout (it takes phase 15's cases, the stress
grid and its timing helpers from ``chip_smoke.py``). ``--parent`` is an
earlier one-thread-a-ray DDA kernel with the same ``yacge_dda_launch``.
Each step is built alone into a library under ``build/dda_ladder/`` (one
``nvcc`` each, all at once, ``-Xptxas -v`` printed). The steps, in order:

  parent      one thread a ray, a 64-bit cell index, (p - origin) / h
  round       the port's kernel (``ops/csrc/dda_kernel.cu``): the shorter
              round, a 32-bit index as two products, the exact product by
              1/h where h is a power of two, floor(x) + up for the
              boundary, one select for each NaN-aware minimum and maximum,
              the cell read beside the boundary and the next t of a
              jump-0 cell, invariants hoisted
  ahead1      the read-ahead variant (``tools/csrc/dda_read_ahead.cu``)
              with one round a batch: the same rounds through its batch
              code
  always2     the variant reading the cells of 2 rounds ahead every batch
  always4     ... of 4 rounds
  ahead2      2 rounds read ahead while a lane of the warp has just
              committed a round of jump 0
  ahead4      ... 4 rounds
  ahead8      ... 8 rounds
  ahead4run2  4 rounds once a lane has 2 rounds of jump 0 in a row
  threads64   ``ahead1`` at 64 threads a block (the others take 128)
  threads256  ... at 256 threads a block

Cases: phase 15's ``voxel_cave`` primary and bounce rays and the primary
rays of ``voxel_test``'s DDA form at 160x180, and the first 28,800-ray and
57,600-ray DDA sweeps of a forced-DDA island frame (the default island,
generated into a temporary directory). Each step's outputs are held
bit-equal to the plain loop's on every case and on the stress grid
(``chip_smoke.dda_stress_cases``, 4,608 rays at each voxel size), then
timed on the cases in turns (the steps in order, then in reverse): device
time (``chip_smoke.kernel_ms``, torch.profiler) and CUDA events, each a
mean over ``--reps`` launches. Then, for the parent and the port's
kernel: the launch floor (the same launch on the same number of rays,
every ray missing the grid box, so each thread only sets up) and the
chain floor (the kernel on the 8 rays with the most rounds alone,
``dda.march_counts``); and a sweep's host time through the port's
``intersect_voxels``, CUDA events of the whole sweep less the kernel's
device time (the median of 7 turns of 100 sweeps).
Prints the card, a line a case and a JSON line of everything; writes the
same to ``chiprun_out/dda_ladder.txt``. Exits non-zero without a CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..ops import dda, kernels
from ..ops.intersect import Hit, _lanes
from ..utils.profiling import card_line
from .profile_frame import cuda_ms

OUT = "chiprun_out"
BUILD = kernels.BUILD_DIR.parent / "dda_ladder"
VARIANT = Path(__file__).resolve().parent / "csrc" / "dda_read_ahead.cu"
# step: the source ("parent", "port" or the variant's (rounds a batch,
# threads a block, jump-0 rounds in a row before a warp reads ahead)).
STEPS = {"parent": "parent", "round": "port", "ahead1": (1, 128, 1),
         "always2": (2, 128, 0), "always4": (4, 128, 0),
         "ahead2": (2, 128, 1), "ahead4": (4, 128, 1), "ahead8": (8, 128, 1),
         "ahead4run2": (4, 128, 2), "threads64": (1, 64, 1),
         "threads256": (1, 256, 1)}
PORT = "round"
TAIL = 8   # the rays with the most rounds, timed alone
STRESS_RAYS = 4608
HOST_TURNS, HOST_REPS = 7, 100   # a sweep's host time: turns, sweeps a turn


def build(parent: Path) -> dict:
    """{step: (CDLL, ptxas report)}, one nvcc each, started together."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for step, how in STEPS.items():
        path, extra = VARIANT, []
        if how == "parent":
            path = parent
        elif how == "port":
            path = kernels.CSRC / "dda_kernel.cu"
        else:
            extra = [f"-DYACGE_DDA_AHEAD={how[0]}",
                     f"-DYACGE_DDA_THREADS={how[1]}",
                     f"-DYACGE_DDA_RUN={how[2]}"]
        so = BUILD / f"lib_{step}.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, *extra, "-Xptxas",
               "-v", "-shared", "-o", str(so), str(path)]
        procs[step] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for step, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {step}:\n{err}")
        lib = ctypes.CDLL(str(so))
        argtypes, restype = kernels._SIGNATURES["yacge_dda_launch"]
        lib.yacge_dda_launch.argtypes = argtypes
        lib.yacge_dda_launch.restype = restype
        libs[step] = (lib, " ".join(
            line.strip() for line in err.splitlines()
            if "registers" in line or "spill" in line))
    return libs


def launcher(libs: dict, step: str, w, o, d, lo, hi):
    """(launch, Hit) of ``step`` on rays o, d with (P,) bounds lo, hi:
    ``launch()`` launches the step's kernel once into the Hit's
    tensors."""
    P = o.shape[0]
    dev = o.device
    z = torch.empty(P, device=dev)
    out = Hit(t=torch.empty(P, device=dev), n=torch.empty((P, 3), device=dev),
              u=z, v=z, mat=torch.empty(P, dtype=torch.int32, device=dev),
              hit=torch.empty(P, dtype=torch.bool, device=dev))
    nx, ny, nz = w.cells.shape
    args = (w.cells.data_ptr(), nx, ny, nz, w.origin.data_ptr(),
            w.voxel_size.data_ptr(), o.data_ptr(), d.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), P, out.t.data_ptr(),
            out.n.data_ptr(), z.data_ptr(), out.mat.data_ptr(),
            out.hit.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    lib = libs[step][0]

    def launch():
        kernels.check(lib.yacge_dda_launch(*args), f"DDA step {step}")
    return launch, out


def held(libs: dict, w, o, d, tmin, tmax):
    """The plain loop's Hit on these rays, every step's launch held
    bit-equal to it; {step: launch}."""
    from chip_smoke import bit_contract
    lo, hi = _lanes(tmin, o), _lanes(tmax, o)
    plain = dda.intersect_voxels(w, o, d, lo, hi, impl="plain")
    runs = {}
    for step in STEPS:
        launch, out = launcher(libs, step, w, o, d, lo, hi)
        launch()
        torch.cuda.synchronize()
        bit_contract(out, plain)
        runs[step] = launch
    return plain, runs


def island_cases(dev) -> dict:
    """Phase 18's first 28,800-ray and 57,600-ray DDA sweeps of a
    forced-DDA island frame from the orbit's first pose."""
    from chip_smoke import (FB_H, FB_W, island_config, island_dda_cases,
                            orbit_poses, record_calls)
    from ..render.renderer import RaytraceRenderer
    from ..world import worldgen
    from ..world.persistence import save_world
    from ..world.volume_scene import build_minecraft_like
    cfg = island_config()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "island.vg")
        blocks, meta = worldgen.generate_world(cfg)
        save_world(path, blocks, meta)
        del blocks, meta
        vs = build_minecraft_like(cfg, world_path=path, surface_mesh=False,
                                  device=dev)
        try:
            r = RaytraceRenderer(vs.update(1.0 / 30.0), FB_W, FB_H,
                                 device=dev)
            r.set_camera(*orbit_poses(vs, 1)[0])
            calls = record_calls(r.render, dda, "intersect_voxels")
        finally:
            vs.manager.shutdown()
    cases = island_dda_cases(calls)
    return {k: cases[k] for k in ("island_dda_28800", "island_dda_57600")}


def missing_rays(w, P: int, dev):
    """P rays that miss the grid box: from far below its min corner,
    pointing away from it."""
    o = (w.origin - 1000.0).expand(P, 3).contiguous()
    d = torch.full((P, 3), -(3.0 ** -0.5), device=dev)
    return o, d


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dda_ladder: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from chip_smoke import (HI_H, HI_W, bit_contract, dda_cases,
                            dda_stress_cases, kernel_ms)
    dev = torch.device("cuda", 0)
    libs = build(args.parent)
    lines = [f"card: {card_line(dev)}"]
    lines += [f"ptxas {k}: {v[1]}" for k, v in libs.items()]
    for name, case in dda_stress_cases(dev, STRESS_RAYS).items():
        held(libs, *case)
    lines.append(f"every step bit-equal to the plain loop on the stress "
                 f"grid ({STRESS_RAYS} rays at each voxel size)")
    cases = {**dda_cases(dev, HI_W, HI_H), **island_cases(dev)}
    steps = list(STEPS)
    res = {}
    for name, (w, o, d, tmin, tmax) in cases.items():
        lo, hi = _lanes(tmin, o), _lanes(tmax, o)
        plain, runs = held(libs, w, o, d, tmin, tmax)
        times = {s: {"ms": [], "event_ms": []} for s in steps}
        for step in (*steps, *reversed(steps)):
            times[step]["ms"].append(kernel_ms(runs[step], args.reps))
            times[step]["event_ms"].append(cuda_ms(runs[step], args.reps))
        mean = {s: sum(times[s]["ms"]) / 2 for s in steps}
        P = o.shape[0]
        work, _ = dda.march_counts(w, o, d, lo, hi)
        rounds = work["rounds"]
        top = torch.argsort(rounds, descending=True)[:TAIL]
        sub = [x[top].contiguous() for x in (o, d, lo, hi)]
        sub_plain = dda.intersect_voxels(w, *sub, impl="plain")
        mo, md = missing_rays(w, P, dev)
        floors = {}
        for step in ("parent", PORT):
            launch, out = launcher(libs, step, w, *sub)
            launch()
            torch.cuda.synchronize()
            bit_contract(out, sub_plain)
            miss, out = launcher(libs, step, w, mo, md, lo, hi)
            miss()
            torch.cuda.synchronize()
            assert not out.hit.any(), "a missing ray hit"
            floors[step] = {"chain_ms": kernel_ms(launch, args.reps),
                            "launch_ms": kernel_ms(miss, args.reps),
                            "launch_event_ms": cuda_ms(miss, args.reps)}
        # A sweep's host time: the whole sweep by CUDA events less the
        # kernel's device time; the median of HOST_TURNS turns of
        # HOST_REPS sweeps each.
        bit_contract(dda.intersect_voxels(w, o, d, tmin, tmax), plain)
        turns = sorted(cuda_ms(lambda: dda.intersect_voxels(w, o, d, tmin,
                                                            tmax), HOST_REPS)
                       for _ in range(HOST_TURNS))
        host_us = 1000.0 * (turns[HOST_TURNS // 2] - mean[PORT])
        res[name] = {
            "rays": P, "hits": int(plain.hit.sum()),
            "rounds": int(rounds.sum()), "max_rounds": int(rounds.max()),
            "steps": times, "floors": floors,
            "tail": {"rays": TAIL, "min_rounds": int(rounds[top].min())},
            "host_us": host_us}
        row = ", ".join(
            f"{s} {mean[s]:.6f} ms ("
            f"{'/'.join(f'{x:.6f}' for x in times[s]['ms'])}; events "
            f"{'/'.join(f'{x:.6f}' for x in times[s]['event_ms'])})"
            for s in steps)
        fl = "; ".join(
            f"{s}: launch floor {f['launch_ms']:.6f} ms (events "
            f"{f['launch_event_ms']:.6f}), the {TAIL} rays with the most "
            f"rounds ({int(rounds[top].min())}-{int(rounds.max())}) alone "
            f"{f['chain_ms']:.6f} ms" for s, f in floors.items())
        lines.append(
            f"{name} ({P} rays, {int(rounds.sum())} rounds, at most "
            f"{int(rounds.max())} a ray; every step bit-equal to the plain "
            f"loop): {row}; {fl}; host us a sweep (events less device "
            f"time) {host_us:.2f}")
    lines.append(json.dumps({"card": card_line(dev), "port": PORT,
                             "ptxas": {k: v[1] for k, v in libs.items()},
                             "cases": res}))
    text = "\n".join(lines)
    print(text, flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "dda_ladder.txt"), "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
