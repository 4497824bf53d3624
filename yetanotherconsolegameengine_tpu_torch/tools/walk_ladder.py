"""The BVH walk kernel's design steps against the kernel they replaced, timed
in one process on one card.

    git show <commit>:yetanotherconsolegameengine_tpu_torch/ops/csrc/bvh_kernel.cu \
        > build/walk_ladder/parent_bvh_kernel.cu
    python3 -m yetanotherconsolegameengine_tpu_torch.tools.walk_ladder \
        --parent build/walk_ladder/parent_bvh_kernel.cu [--reps 20]

Run from the root of the checkout (it takes phase 11's cases from
``chip_smoke.py``). ``--parent`` is an earlier one-thread-a-ray walk kernel
whose ``yacge_bvh_launch`` reads the 240-byte node rows (``MeshBVH.rows``).
It and ``ops/csrc/bvh_kernel.cu`` built with one lane a ray
(``-DYACGE_BVH_LANES=1``) and with its default four are each built alone
into a library under ``build/walk_ladder/`` (one ``nvcc`` each, all at
once, ``-Xptxas -v`` printed). The steps, in order:

  parent        one thread a ray on the node rows
  split         one thread a ray on ``heads``/``tris``, headers through L1
  split+shared  the same with the headers staged in shared memory
  lanes         four lanes a ray, headers through L1 (``n_shared`` 0)
  lanes+shared  four lanes a ray, headers staged up to
                ``mesh_bvh.HEAD_BUDGET``: the port's kernel
  lanes+all     the same, staged up to the block's opt-in shared memory

On phase 11's bunny primary and bounce, ``make_knot`` LBVH and large-LBVH
cases at 160x180 rays, each step's outputs are held bit-equal to the plain
walk's, then timed in turns (the steps in order, then in reverse): device
time (``chip_smoke.kernel_ms``, torch.profiler) and CUDA events, each a
mean over ``--reps`` launches. Then the port's kernel on the 8 rays of the
case with the most node visits alone (``mesh_bvh.walk_counts``), by device
time, beside the whole sweep's. Prints the card, a line a case and a JSON
line of everything; writes the same to ``chiprun_out/walk_ladder.txt``.
Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import kernels, mesh_bvh
from ..ops.intersect import Hit, _lanes
from ..utils.profiling import card_line
from .profile_frame import cuda_ms

OUT = "chiprun_out"
BUILD = kernels.BUILD_DIR.parent / "walk_ladder"
CASES = ("bunny_primary", "bunny_bounce", "knot_lbvh", "large_lbvh")
STEPS = ("parent", "split", "split+shared", "lanes", "lanes+shared",
         "lanes+all")
TAIL = 8   # the rays with the most visits, timed alone


def build(parent: Path) -> dict:
    """{name: (CDLL, ptxas report)} for the parent and the two lane
    counts, one nvcc each, started together."""
    src = kernels.CSRC / "bvh_kernel.cu"
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {"parent": (parent, []), "lanes1": (src, ["-DYACGE_BVH_LANES=1"]),
            "lanes4": (src, [])}
    procs = {}
    for name, (path, extra) in jobs.items():
        so = BUILD / f"lib_{name}.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, *extra, "-Xptxas",
               "-v", "-shared", "-o", str(so), str(path)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for name, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        lib = ctypes.CDLL(str(so))
        lib.yacge_bvh_launch.restype = ctypes.c_int
        if name != "parent":
            sig = kernels._SIGNATURES
            lib.yacge_bvh_launch.argtypes = sig["yacge_bvh_launch"][0]
            lib.yacge_bvh_limits.argtypes = sig["yacge_bvh_limits"][0]
            lib.yacge_bvh_limits.restype = ctypes.c_int
        else:
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.yacge_bvh_launch.argtypes = [P, I, P, P, P, P, I, *[P] * 7]
        libs[name] = (lib, " ".join(line.strip() for line in err.splitlines()
                                    if "registers" in line or "spill" in line))
    return libs


def launcher(libs: dict, step: str, bvh, o, d, lo, hi):
    """(launch, Hit, shape) of ``step`` on one case: ``launch()`` launches
    the step's kernel once into the Hit's tensors."""
    P = o.shape[0]
    dev = o.device
    out = Hit(t=torch.empty(P, device=dev), n=torch.empty((P, 3), device=dev),
              u=torch.empty(P, device=dev), v=torch.empty(P, device=dev),
              mat=torch.empty(P, dtype=torch.int32, device=dev),
              hit=torch.empty(P, dtype=torch.bool, device=dev))
    ptrs = [x.data_ptr() for x in (out.t, out.n, out.u, out.v, out.mat,
                                   out.hit)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if step == "parent":
        lib, rows = libs["parent"][0], bvh.rows
        args = (rows.data_ptr(), bvh.n_nodes, o.data_ptr(), d.data_ptr(),
                lo.data_ptr(), hi.data_ptr(), P, *ptrs, stream)
        shape = {"lanes": 1, "n_shared": 0, "blocks": -(-P // 128)}
    else:
        lib = libs["lanes1" if step.startswith("split") else "lanes4"][0]
        optin, sms = mesh_bvh._limits(lib, dev.index, 0)[:2]
        budget = {"shared": min(optin, mesh_bvh.HEAD_BUDGET),
                  "all": optin}.get(step.partition("+")[2], 0)
        n_shared = mesh_bvh.shared_nodes(bvh.n_nodes, budget)
        smem = n_shared * mesh_bvh.HEAD_F * 4
        _, _, per_sm, _, lanes = mesh_bvh._limits(lib, dev.index, smem)
        shape = {"lanes": lanes, "n_shared": n_shared, "blocks":
                 mesh_bvh.grid_blocks(P, sms, per_sm, 32 // lanes)}
        args = (bvh.heads.data_ptr(), bvh.tris.data_ptr(), bvh.n_nodes,
                shape["n_shared"], shape["blocks"], o.data_ptr(),
                d.data_ptr(), lo.data_ptr(), hi.data_ptr(), P, *ptrs, stream)

    def launch():
        kernels.check(lib.yacge_bvh_launch(*args), f"walk step {step}")
    return launch, out, shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("walk_ladder: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from chip_smoke import HI_H, HI_W, bit_contract, kernel_ms, walk_cases
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = build(args.parent)
    lines = [f"card: {card_line(dev)}"]
    lines += [f"ptxas {k}: {v[1]}" for k, v in libs.items()]
    cases = walk_cases(dev, HI_W, HI_H)
    res = {}
    for name in CASES:
        bvh, o, d, lo, hi = cases[name]
        lo, hi = _lanes(lo, o), _lanes(hi, o)
        plain = mesh_bvh.intersect_mesh(bvh, o, d, lo, hi, impl="plain")
        runs = {}
        for step in STEPS:
            launch, out, shape = launcher(libs, step, bvh, o, d, lo, hi)
            launch()
            torch.cuda.synchronize()
            bit_contract(out, plain)
            runs[step] = (launch, shape)
        times = {s: {"ms": [], "event_ms": []} for s in STEPS}
        for step in (*STEPS, *reversed(STEPS)):
            launch = runs[step][0]
            times[step]["ms"].append(kernel_ms(launch, args.reps))
            times[step]["event_ms"].append(cuda_ms(launch, args.reps))
        # The port's kernel on the rays with the most visits alone: how
        # much of the sweep the longest walks set by themselves.
        visits = mesh_bvh.walk_counts(bvh, o, d, lo, hi)[0]["visits"]
        top = torch.argsort(visits, descending=True)[:TAIL]
        sub = [x[top].contiguous() for x in (o, d, lo, hi)]
        launch, out, _ = launcher(libs, "lanes+shared", bvh, *sub)
        launch()
        torch.cuda.synchronize()
        bit_contract(out, mesh_bvh.intersect_mesh(bvh, *sub, impl="plain"))
        tail_ms = kernel_ms(launch, args.reps)
        sweep_ms = sum(times["lanes+shared"]["ms"]) / 2
        res[name] = {
            "nodes": bvh.n_nodes, "rays": o.shape[0],
            "steps": {s: dict(times[s], shape={
                k: runs[s][1][k] for k in ("lanes", "n_shared", "blocks")})
                for s in STEPS},
            "tail": {"rays": TAIL, "visits": int(visits[top].min()),
                     "max_visits": int(visits.max()), "ms": tail_ms,
                     "share_of_sweep": tail_ms / sweep_ms}}
        row = ", ".join(
            f"{s} {sum(times[s]['ms']) / 2:.5f} ms "
            f"({'/'.join(f'{x:.5f}' for x in times[s]['ms'])}; events "
            f"{'/'.join(f'{x:.5f}' for x in times[s]['event_ms'])})"
            for s in STEPS)
        lines.append(f"{name} ({bvh.n_nodes} nodes, {o.shape[0]} rays, all "
                     f"steps bit-equal to the plain walk): {row}; the "
                     f"{TAIL} rays with the most visits "
                     f"({int(visits[top].min())}-{int(visits.max())}) alone: "
                     f"{tail_ms:.5f} ms, {tail_ms / sweep_ms:.1%} of the "
                     f"sweep")
    lines.append(json.dumps(res))
    text = "\n".join(lines)
    print(text, flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "walk_ladder.txt"), "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
