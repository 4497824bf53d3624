"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (one line each; any failure raises and exits non-zero):
  1. environment: card name and power limit, CUDA and toolkit versions
  2. build the CUDA kernels from yetanotherconsolegameengine_tpu_torch/ops/csrc
  3. trace kernel vs its plain PyTorch version (cornell, glass,
     mirror_spheres at 160x180, frame 3)
  4. post kernel vs its plain version on traced cornell planes at 160x180
     and 240x270 (the dragon's frame size), fused tail on and off
  5. the renderer on the card vs tests/goldens.npz (48x28 cells, 4 frames)
  6. Cornell at 160x90 cells (160x180 pixels), ss=1, through
     RaytraceRenderer.render_many on the kernels: kernel vs plain renderer
     over 4 frames, then the timed run, whose kernel launch counts must be
     non-zero, then each kernel's time per call at the frame's shapes: as
     device time (the mean duration of its launches, from torch.profiler)
     and by CUDA events over back-to-back calls, which the wrapper's host
     time can pace, beside its plain version and its least time on the
     card; (6d) the post kernel under the configurations whose phases read
     their taps from global memory (a fifth a-trous pass; a TAA clamp
     radius of 77) against its plain version at 160x180 within phase 4's
     contract, then its device and CUDA-event times, least time and share
  7. the cluster kernel (K3) vs its plain version on the dragon's sweeps of
     frame 3 at 240x270 pixels: every sweep of the frame (the fine set's
     primary rays, the shadow set's light-major any-hit shadow rays, the
     LOD set's bounce rays), then the same primary rays on the full
     598k-triangle set; nearest mode: winners and t bit-equal; any-hit
     mode: equal hit masks and every winner a real blocker; (7b) the cull
     and resolve kernels (``ops/csrc/cluster_glue.cu``) against their
     torch twin on the same sweeps and on ``glue_cases``: K3's inputs and
     the Hit bit for bit, then each sweep's cull and resolve timed without
     K3 (device time and CUDA events, the twin by events) beside its least
     time
  8. the cluster goldens (cluster_forced, fine_forced) on the card (48x28
     cells, 4 frames, kernels)
  9. the dragon at 240x135 cells, ss=1: kernel vs plain renderer over 4
     frames, then the timed render_many, whose cluster and post kernel
     launch counts must be non-zero, then K3's own time on each sweep of
     the frame (device time and CUDA events) against its plain version and
     its least time on the card
 10. the LBVH built on the card (``ops/lbvh.py``) equals the CPU build for
     ``make_knot`` (3,840 triangles), with its build time on the card
 11. the BVH walk kernel (``ops/csrc/bvh_kernel.cu`` through
     ``ops/mesh_bvh.py::intersect_mesh``) against the plain walk on the
     card, bit for bit (t, n, u, v, mat, hit), at 160x180 rays a case: the
     bunny's primary rays and bounce rays from their hits, rays at the
     ``make_knot`` LBVH and at a 15,360-triangle knot's LBVH (8,191 nodes,
     more headers than the walk stages), ``exhibit_ring``'s
     primary and bounce rays at its glass hero mesh; then every walk sweep
     of an ``exhibit_ring`` frame at 160x90; the bunny's primary rays
     against the CPU; per case the kernel's device time and the sweep's
     CUDA-event time, the work the rays need (node visits, triangle tests,
     rows read, the most visits of a ray, the share of a warp's visit
     slots used), the least time and the launch (shared bytes, headers
     staged, blocks, blocks an SM: every header staged where the table
     fits, the large tree's tail read through L1); the plain walk's time
     on the bunny's primary rays
 12. the ``glass_gem`` and ``texture_test`` goldens on the card (48x28
     cells, 4 frames, kernels), the post kernel launched
 13. the bunny at 160x90 cells, ss=1 (28,800 primary lanes, its LBVH built
     on the card at ``set_scene``): kernel vs plain renderer over 4 frames,
     then the timed ``render_many`` (ms/frame by CUDA events and host
     clock, Mray/s), whose post and walk kernel launch counts must be
     non-zero; then
     ``demo_random`` at 160x90 (74 spheres in a 128-row table): the trace
     kernel vs its plain version, kernel vs plain renderer, and a timed
     ``render_many`` whose trace and post launch counts must be non-zero
 14. one ``video_texture`` frame on the card: the synthetic reader's newest
     frame written into its slot, TAA reset, the post kernel launched
 15. the voxel DDA kernel (``ops/csrc/dda_kernel.cu`` through
     ``ops/dda.py::intersect_voxels``) against the plain loop on the card,
     bit for bit, at 160x180 rays a case: ``voxel_cave``'s primary rays and
     bounce rays from their hits, the primary rays of ``voxel_test``'s DDA
     form, and the stress grid (``dda_stress_cases``: rays that graze a
     surface one cell a round, jump, leave the grid or stop at a per-ray
     tmax, at voxel sizes 1, 0.5, 2 and 0.3); ``voxel_cave``'s primary
     rays against the CPU (t bit-equal);
     per case the kernel's times, the work (rounds, cells read, the most
     rounds of a ray, the warp share) and the least time; the plain loop's
     time; then ``voxel_cave`` at 160x90 timed, the DDA kernel launched
 16. the ``voxel_test`` and ``island_surface`` goldens on the card (48x28
     cells, 4 frames): ``voxel_test`` through the trace kernel, the island
     through the cluster kernel, held against the plain renderer on the
     card and reported against the golden (the JAX kernel's bfloat16
     arithmetic moves a few cells of that golden); then ``voxel_test`` at
     160x90 through the trace kernel and its DDA form through the DDA
     kernel, each kernel vs plain renderer and timed
 17. the default island (256x128x256 voxels, a 224x128x224 window; surface
     tables of 1,536 and 256 clusters): generation, save and load times,
     the surface tables built on the card equal to a CPU build, kernel vs
     plain renderer on one frame, then a 64-pose orbit at 160x90 and at
     240x135 (ms/frame by CUDA events, Mray/s, launches, the device idle
     share from torch.profiler)
 18. the same island forced onto the DDA (``surface_mesh=False``) at
     160x90: kernel vs plain renderer on one frame, every DDA sweep of a
     frame against the plain loop bit for bit, the first sweep of each
     size (28,800 and 57,600 rays) timed as phase 15 times its cases,
     ms/frame and DDA sweeps
 19. one frame each of ``teapot``, ``cow``, ``all_meshes`` and ``museum``
     on the card against the port's plain renderer on the CPU, the walk
     kernel launched, then each timed at 160x90 (the walk and primitive
     kernels launched)
 20. dynamic scenes: ``exhibit_ring`` and ``spinning_mesh`` patched on the
     card (``DynamicScene.at_time``, the spinning mesh's LBVH rebuilt
     there) equal to the CPU at t = 0, 1.3 and 2.0, with the patch time;
     at 160x90 (bench_suite's "Spinning mesh" row) kernel vs plain
     renderer over 2 frames of ``render_many(times=, scene_fn=)``, then a
     timed ``render_many`` of 10 frames each: K1 and the walk kernel
     launched, K2 not
 21. the terminal program (``engine.program.main``, fd 1 on a temporary
     file) on Cornell at 160x90 for 60 ticks with ``--batch 1`` and
     ``--batch 8``: ANSI frames and HUD written, K2 and K1 launched, the
     native encoder loaded, ms a tick from the HUD beside ``render_many``'s
     ms/frame of the same frame; then the batched component against the
     unbatched one (Cornell 160x90 K=4, ``spinning_mesh`` 48x28 K=3):
     fg/bg grids bit-equal, RGB within 1/255
 22. the video mode's frame on the card vs the CPU (RGB within 1e-5, ANSI
     equal); the SCNE snapshot of Cornell on the card byte-equal to the
     CPU's; a replica read onto the card renders as the original
 23. multi-device row sharding (``parallel/sharding.py``), the ranks
     sharing the one card over gloo with the exchange staged through pinned
     host memory: (a) K2 on the bands of 2 and 4 ranks of Cornell 160x180
     bit-equal to those rows of the full-frame K2, and K1's band mode
     (launch A on each extended band, launch B on the combined partial)
     against ``post_plain``'s band mode within phase 4's contract, tail on
     and off, with each launch's device time; (b) ``dryrun(4)``; (c) the
     sharded frames against the unsharded frame on the card: Cornell 160x90
     on 2 ranks and 160x88 on 2 and 4 (90 cell rows do not split into 4
     whole-cell bands; top within 2e-5, fg equal), the dragon on 2 ranks
     at 240x136 (nor 135 into 2; built on rank 0 and broadcast; top within
     2e-5, fg flips under 0.5%), and cluster_forced, voxel_test, its DDA form and the teapot at
     48x28 on 4 ranks (14-row bands, halos over several owners), every
     rank's launch counts; (d) Cornell 160x88 ms/frame by CUDA events at 1,
     2 and 4 ranks on the one card (the cost of the exchange and the split
     post where ranks share a card, not a scale-out figure); (e) the scenes
     of (c) at world 1 over the group ``make_group`` makes by default on
     CUDA (NCCL, the exchange on the card, nothing staged; no
     fallback): every frame bit-equal to the world-1 gloo
     frame and held to (c)'s contract against the unsharded frame, the
     kernels launched; a scene of every tensor dtype of the shipped scenes
     through ``broadcast_scene``, exact; ``combine``'s partial against the
     unsharded exposure; Cornell 160x88 ms/frame over NCCL and gloo in
     turns, beside the unsharded ``render()`` a frame
 24. the benchmark suite (``…_torch/bench_suite.py``) on the card: (a)
     ``mirror_spheres`` at 240x135 with ss=2 (480x540 traced pixels),
     kernel vs plain renderer over 4 frames, and a room lit by 10 lights
     (more than the JAX megakernel takes) through the trace kernel
     against its plain version at 160x180 and kernel vs plain renderer at
     160x90; (b) the suite's rows 1-5 (Cornell, mirror spheres at ss=1
     and 2, the primitive showcase, voxel_test; sustained batches cut to
     200 frames), each row's trace and post kernels first held against
     their plain versions on its scene at its own traced size (160x180,
     240x270, 480x540), and its LBVH row through the suite's own
     functions, each printed row parsed, its rates finite and positive
     and its ``kernels`` those of the scene's route; (c) ``python -m
     yetanotherconsolegameengine_tpu_torch.bench`` once
 25. the primitive kernel (``ops/csrc/prim_kernel.cu`` through
     ``ops/intersect.py::sweep_primitives``) against the plain loop
     (``intersect_primitives``) on the card, bit for bit, on every
     primitive sweep of a museum frame at 160x90 (28,800 rays a round,
     230,400 light lanes a shadow sweep); one sweep of each width timed
     (device time, CUDA events, the plain loop), with its least time and
     share; then ``prim_cases`` at 64x48 (the scenes' primary, bounce and
     shadow rays, the stress tables and rays, each table alone, none, and
     spheres and triangles of 600 more rows) bit for bit
Every timed run asserts that the plain walk and DDA loops ran no round.
Then a JSON line of per-kernel results (``ms`` is the device time,
``event_ms`` the CUDA-event time, ``share`` the bound over ``ms``;
``launches`` counts Cornell's timed run for K1 and K2, the dragon's for
K3, the bunny's for the walk kernel and the forced-DDA island's for the
DDA kernel, ``launches_by_path`` every timed run, the shell's runs, the
sharded runs and the suite's rows; K1's ``global_memory`` holds phase
6d; the walk kernel's ``cases`` its phase 11 cases, the DDA kernel's its
phase 15 cases and phase 18's island sweeps; the primitive kernel's
times its 28,800-ray sweep, ``shadow_sweep`` its 230,400-ray one),
the card's name and power limit, and as the last line
{"ok": true, "device": {...}}.

Imports nothing of JAX: the JAX package is not needed on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from yetanotherconsolegameengine_tpu_torch.config import DEFAULT_CONFIG
from yetanotherconsolegameengine_tpu_torch.core.camera import (
    make_jittered_rays, ray_params)
from yetanotherconsolegameengine_tpu_torch.ops import (cluster_kernel, dda,
                                                       intersect, kernels,
                                                       lbvh, mesh_bvh,
                                                       mesh_clusters,
                                                       post_kernel)
from yetanotherconsolegameengine_tpu_torch.ops import trace_kernel
from yetanotherconsolegameengine_tpu_torch.ops.intersect import (
    INF, INTERSECTORS, _lanes, intersect_primitives)
from yetanotherconsolegameengine_tpu_torch.render.renderer import (
    RaytraceRenderer, trace_wavefront_planes)
from yetanotherconsolegameengine_tpu_torch.scene.builders import SCENE_BUILDERS
from yetanotherconsolegameengine_tpu_torch.scene.mesh_loader import (
    make_dragon, make_knot, transform_mesh)
from yetanotherconsolegameengine_tpu_torch.scene.mesh_scenes import (
    FORCED_SCENE_BUILDERS)
from yetanotherconsolegameengine_tpu_torch.utils.profiling import timed

ROOT = os.path.dirname(os.path.abspath(__file__))
TRACE_SCENES = ("cornell", "glass", "mirror_spheres")
FB_W, FB_H = 160, 90            # the headline frame: 160x180 traced pixels
HI_W, HI_H = FB_W, FB_H * 2
TRACE_FRAME = 3
TIMED_FRAMES = 200
DRAGON_W, DRAGON_H = 240, 135   # the mesh frame: 240x270 traced pixels
DRAGON_FRAMES = 20
BUNNY_FRAMES = 30               # the small-mesh frame: 160x180 traced pixels
MESH_FRAMES = 10                # teapot, cow, all_meshes, museum at 160x90
CAVE_FRAMES = 30                # voxel_cave at 160x90
DEMO_FRAMES = 100
VOXEL_FRAMES = 100              # voxel_test 160x90 through K2
VOXEL_DDA_FRAMES = 10           # its DDA form, the torch DDA
ORBIT_POSES = 64                # bench_suite's island orbit
SHARD_FRAMES = 4                # frames of each sharded contract run
SHARD_TIMED = 100               # timed sharded Cornell 160x90 frames
SHARD_DRAGON_TIMED = 5
# Bands are whole cells of equal height (fb_h and 2 * fb_h must divide by
# the world, as in the JAX package): 135 cell rows do not split into 2
# bands nor 90 into 4, so the 2-rank dragon renders 240x136 and Cornell on
# 4 ranks, and the timed Cornell frames at 1, 2 and 4 ranks, 160x88.
SHARD_DRAGON_H = 136
SHARD_FB_H = 88
DDA_ISLAND_FRAMES = 32          # the forced-DDA island
DYNAMIC_TIMES = (0.0, 1.3, 2.0)
SPIN_FRAMES = 10                # bench_suite's "Spinning mesh" row, 160x90
RING_FRAMES = 10
SHELL_TICKS = 60                # the terminal program's frames
# bench_suite rows 1-5 with their sustained batches cut from 2000 frames
# (400 at ss=2) to this many, so phase 24 stays near a minute.
SUITE_BATCH = 200
N_LIGHTS = 10                   # above the JAX megakernel's limit of 8
# fp32 operations per K2 ray-primitive test (a slab test: 6 sub, 6 mul,
# 12 min/max) and per K1 pixel and stage: the TAA 3x3 clamp ~100, a 5x5
# a-trous pass of 25 taps x ~30, the exposure sample's luma and log ~10,
# the tail (ACES, gamma, saturation, ANSI-256) ~50. Least times follow
# ``roofline`` (K3's work: ``k3_work``).
K2_OPS = 24
K1_TAA_OPS, K1_PASS_OPS, K1_LOG_OPS, K1_TAIL_OPS = 100, 750, 10, 50
# Of the TAA's ~100, 3 per tap of the 3x3 clamp window (the sky test, the
# min and the max); a clamp radius r has (2r + 1)^2 taps.
K1_CLAMP_TAP_OPS = 3
# K1's configurations whose phases read their taps from global memory, not
# from shared memory (tests/test_torch_cuda.py::
# test_post_kernel_wide_halos_match_plain): a fifth a-trous pass (+-32
# halo) and a TAA clamp radius of 77.
K1_GLOBAL = {"five_passes": {"atrous_iterations": 5},
             "clamp_radius_77": {"taa_clamp_radius": 77}}
# 4-byte planes K1 must read and write once per pixel: of the G-buffer the
# 11 it reads (radiance 3, sky, albedo 3, normal 3, depth; not the ray
# count), of the previous frame's depth, normal and sky (5), the history's
# RGB (3); out 6 RGB planes and the ANSI index plane.
K1_PLANES = 11 + 5 + 3 + 7
# fp32 operations of one row test of each primitive type in the primitive
# kernel (ops/csrc/prim_kernel.cu; arithmetic and comparisons, the
# winner's normal and u, v not counted), and the bytes a ray must move: o
# and d in (24), t, n, u, v, mat and hit out (29), and 4 for each bound
# given per lane; each table column is read once.
PRIM_ROW_OPS = {"spheres": 27, "boxes": 29, "rects": 15, "cylinders": 60,
                "disks": 35, "planes": 17, "triangles": 56}
PRIM_RAY_BYTES = 24 + 29
# Least-time model (H100 SXM data sheet at 700 W: fp32 outside the tensor
# cores, HBM3): bound = max(operations / PEAK_FLOPS, bytes / PEAK_BYTES).
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations per K3 lane-test: six 3-term dot products (18 mul, 15
# add), the division, u and v (2 mul, 2 add), 1-u-v (2 sub).
K3_OPS = 40
# Operations of the walk kernel per node visit (the slab test: 6 sub, 6
# mul, 6 min/max, 4 in the two reductions, 3 compares) and per triangle
# test (Moller-Trumbore: two cross products 18, four dot products 20 with
# their 3 scalings, the guarded 1/det 3, o - a 3, 10 compares and u + v);
# of the DDA kernel per round (t + eps 1, the point 6, the cell 9 with its
# division and floor, its clamps and bounds 10, the three boundaries 15
# with their int adds, the parallel-axis selects 3, the minimum 2, the
# distance jump 4, the two maxima 2). Integer work is counted beside the
# fp32 work against the fp32 peak.
WALK_SLAB_OPS = 25
WALK_TRI_OPS = 57
DDA_ROUND_OPS = 52
# Bytes a sweep must move per ray: o, d, tmin and tmax in (32); out t, n,
# u, v, mat and hit (29) for the walk, and the same for the DDA (its u and
# v one zero plane: 25); and once each row (240 bytes) or cell (2 bytes)
# that the rays read.
WALK_RAY_BYTES = 32 + 29
DDA_RAY_BYTES = 32 + 25
ROW_BYTES = 240
CELL_BYTES = 2
# Profiled passes ``kernel_ms`` makes before it falls back to CUDA events.
TRIES = 3
# Bytes the cull and resolve kernels of a cluster sweep must move: per ray
# o and d in (24), the Hit out (29) and 4 for each bound given per lane;
# per padded lane K3's ray row out (32) and its two winner words back (8);
# per entry K3 reads of a tile's list (id and entry t, 8) and per tile its
# length (4); each cluster box in once (24); per hit of a nearest sweep
# its triangle row (64). The cull writes each tile's whole list, the
# clusters out of reach after the rest, but K3 reads only the first
# ``lens`` entries, so only those count.
GLUE_RAY_BYTES = 24 + 29
GLUE_LANE_BYTES = 32 + 8
GLUE_ENTRY_BYTES = 8
GLUE_BOX_BYTES = 24
GLUE_ROW_BYTES = 64


def k1_ops(cfg) -> int:
    """fp32 operations K1 does per pixel under ``cfg``: the TAA with its
    clamp window, every a-trous pass, the exposure sample and the tail.
    The window and the passes change what K1 computes, not what it must
    read and write once: its bytes stay ``K1_PLANES`` a pixel."""
    taps = (2 * max(0, cfg.taa_clamp_radius) + 1) ** 2
    return (K1_TAA_OPS + (taps - 9) * K1_CLAMP_TAP_OPS
            + max(1, cfg.atrous_iterations) * K1_PASS_OPS + K1_LOG_OPS
            + K1_TAIL_OPS)


def trace_contract(got: np.ndarray, ref: np.ndarray) -> dict:
    """Hold (12, H, W) trace planes to the JAX package's own
    megakernel-vs-wavefront contract (tests/test_pallas_trace.py:49-74):
    equal ray counts and sky masks; radiance error relative to max(1, |ref|)
    below 1e-4 per pixel with a mean below 1e-6; albedo and normal within
    1e-4; depth within rtol 1e-4 where the primary ray hit."""
    assert int(got[11].sum()) == int(ref[11].sum()), \
        f"rays_traced {got[11].sum()} != {ref[11].sum()}"
    np.testing.assert_array_equal(got[3], ref[3], err_msg="is_sky")
    err = np.abs(got[0:3] - ref[0:3]) / np.maximum(1.0, np.abs(ref[0:3]))
    assert err.max() < 1e-4, f"radiance rel err {err.max()}"
    assert err.mean() < 1e-6, f"mean radiance rel err {err.mean()}"
    np.testing.assert_allclose(got[4:7], ref[4:7], atol=1e-4,
                               err_msg="albedo")
    np.testing.assert_allclose(got[7:10], ref[7:10], atol=1e-4,
                               err_msg="normal")
    fin = ref[10] < 1e30
    np.testing.assert_array_equal(fin, got[10] < 1e30, err_msg="depth hit")
    np.testing.assert_allclose(got[10][fin], ref[10][fin], rtol=1e-4,
                               atol=1e-4, err_msg="depth")
    return {"radiance_rel": float(err.max()),
            "radiance_abs": float(np.abs(got[0:3] - ref[0:3]).max()),
            "albedo": float(np.abs(got[4:7] - ref[4:7]).max()),
            "normal": float(np.abs(got[7:10] - ref[7:10]).max()),
            "depth_rel": float((np.abs(got[10] - ref[10])[fin]
                                / ref[10][fin]).max())}


def post_contract(got, ref) -> dict:
    """Hold post outputs (blended, mapped-or-denoised, ansi-or-None,
    exposure) to the fused-post contract (tests/test_pallas_post.py:48-63):
    RGB within 2e-3, fewer than 0.5% ANSI index flips, exposure within
    1e-5."""
    np.testing.assert_allclose(got[0], ref[0], atol=2e-3, err_msg="blended")
    np.testing.assert_allclose(got[1], ref[1], atol=2e-3, err_msg="image")
    flips = 0.0
    if ref[2] is not None:
        flips = float((got[2] != ref[2]).mean())
        assert flips < 0.005, f"ANSI flips {flips}"
    assert abs(float(got[3]) - float(ref[3])) <= 1e-5, \
        f"exposure {float(got[3])} vs {float(ref[3])}"
    return {"rgb": float(max(np.abs(got[0] - ref[0]).max(),
                             np.abs(got[1] - ref[1]).max())),
            "ansi_flips": flips,
            "exposure": abs(float(got[3]) - float(ref[3]))}


def _np(x):
    return None if x is None else x.detach().cpu().numpy()


def trace_inputs(scene, w: int, h: int, frame: int, dev):
    """(params (1, 18), frames (1,)) for frame ``frame`` of a scene."""
    params = ray_params(scene.default_pose, w, h, frame)[None]
    return (params.contiguous(),
            torch.tensor([frame], dtype=torch.int32, device=dev))


def roofline(ops: float, nbytes: float):
    """(least ms, "operations" or "bytes") for work of ``ops`` fp32
    operations moving ``nbytes``."""
    t_ops = ops / PEAK_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def k3_work(args, ref) -> dict:
    """What one K3 sweep must do on these inputs, and its least time on the
    card. ``ref``: ``trace_tiles_plain``'s result. A ray must test every
    listed entry whose key is not above its final key (the plain winner's
    key, or key(tinit) without a hit): no other entry can hold its winner.
    Each lane-test is K3_OPS fp32 operations; the bytes are each input
    read once and each output written once."""
    lens, ids, entry_t, gmat, rays, _, qmask = args
    n_tiles, C = ids.shape
    kc = gmat.shape[2]
    key = cluster_kernel.key_of
    final = torch.where(ref[1] >= 0, key(ref[0], qmask),
                        key(rays[:, 7].contiguous(), qmask))
    fk = final.view(n_tiles, -1, 1)
    ek = key(entry_t, qmask).view(n_tiles, 1, C)
    listed = torch.arange(C, device=ids.device)[None] < lens[:, None]
    tests = 0
    for i in range(n_tiles):   # per tile: (256, C) booleans
        tests += int(((ek[i] <= fk[i]) & listed[i, None]).sum()) * kc
    nbytes = sum(x.numel() * x.element_size()
                 for x in (lens, ids, entry_t, gmat, rays))
    nbytes += rays.shape[0] * 8 + n_tiles * 4
    bound, by = roofline(tests * K3_OPS, nbytes)
    return {"tiles": n_tiles, "lane_tests": tests, "bytes": nbytes,
            "bound_ms": bound, "bound_by": by}


def walk_bound(work: dict, rays: int):
    """(least ms, bound by) of a walk sweep whose work ``mesh_bvh.walk_work``
    counted on ``rays`` rays."""
    return roofline(work["visits"] * WALK_SLAB_OPS
                    + work["tri_tests"] * WALK_TRI_OPS,
                    rays * WALK_RAY_BYTES + work["rows"] * ROW_BYTES)


def dda_bound(work: dict, rays: int):
    """(least ms, bound by) of a DDA sweep whose work ``dda.march_work``
    counted on ``rays`` rays."""
    return roofline(work["rounds"] * DDA_ROUND_OPS,
                    rays * DDA_RAY_BYTES + work["cells"] * CELL_BYTES)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()

    def calls():
        for _ in range(reps):
            fn()
    return timed(calls, reps, "cuda")[0]


def device_ms(fn, reps: int, warmup: int = 3):
    """(mean device ms, device operations) per call of ``fn`` over ``reps``
    calls: the summed durations of the device operations the calls ran,
    from ``torch.profiler``. Unlike ``cuda_ms`` it leaves out the gaps in
    which the device waits for the host to enqueue the next call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    host_names = {ev.name for ev in events
                  if ev.device_type != DeviceType.CUDA}
    ops = [ev.time_range.end - ev.time_range.start for ev in events
           if ev.device_type == DeviceType.CUDA and ev.name not in host_names]
    return sum(ops) / 1e3 / reps, len(ops) / reps


def kernel_ms(fn, reps: int, launches: int = 1) -> float:
    """Device time of one call of a wrapper that launches ``launches``
    kernels: the mean duration of the launches ``device_ms`` records over
    ``reps`` calls, times ``launches`` (the profiler can lose a launch's
    record). A pass that kept no record is profiled again, up to
    ``TRIES`` passes; if none kept one, the call is timed by CUDA events
    (launch gaps included) and a line says so."""
    for _ in range(TRIES):
        ms, ops = device_ms(fn, reps)
        assert ops <= launches, f"{ops} device operations a call"
        if ops > 0:
            return ms / ops * launches
    ms = cuda_ms(fn, reps)
    print(f"  the profiler kept no record in {TRIES} passes: "
          f"{ms:.5f} ms by CUDA events", flush=True)
    return ms


def post_inputs(packed, w: int, h: int, dev, cfg=DEFAULT_CONFIG):
    """The post kernel's inputs on traced planes of ``packed``'s scene:
    frames 3 and 2 at w x h, a seeded history, history valid, no reset,
    exposure 0.8."""
    cur, prev = (trace_kernel.trace_planes(
        packed, *trace_inputs(packed.scene, w, h, f, dev), 0, w, h, cfg)
        for f in (3, 2))
    rs = np.random.RandomState(0)
    hist = torch.from_numpy(
        (cur[0:3].cpu().numpy()
         * rs.uniform(0.8, 1.25, (3, h, w))).astype(np.float32)).to(dev)
    valid = torch.ones((), dtype=torch.bool, device=dev)
    reset = torch.zeros((), dtype=torch.bool, device=dev)
    ae = torch.full((), 0.8, dtype=torch.float32, device=dev)
    return cur, prev, hist, valid, reset, ae


def lbvh_contract(got, want) -> dict:
    """Hold an LBVH to another build of the same triangles: every field
    equal, except the unit normals within 1e-6."""
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name).cpu(), getattr(want, f.name).cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        if f.name != "n":
            assert torch.equal(g, w), f"LBVH field {f.name} differs"
    n_err = float((got.n.cpu() - want.n.cpu()).abs().max())
    assert n_err <= 1e-6, f"LBVH normals differ by {n_err}"
    return {"nodes": got.n_nodes, "tris": got.n_tris, "normal_err": n_err}


def hit_contract(got, want) -> dict:
    """Hold a BVH walk's hits to another run on the same rays: equal hit
    masks and materials, t within 1e-6 relative, normals and u, v within
    1e-6; reports how many hits are bit-equal in t."""
    hit = want.hit.cpu()
    assert torch.equal(got.hit.cpu(), hit), "hit masks"
    assert torch.equal(got.mat.cpu()[hit], want.mat.cpu()[hit]), "materials"
    tg, tw = got.t.cpu()[hit], want.t.cpu()[hit]
    t_rel = float(((tg - tw).abs() / tw.abs()).max()) if hit.any() else 0.0
    assert t_rel <= 1e-6, f"t rel err {t_rel}"
    err = max(float((getattr(got, f).cpu()[hit]
                     - getattr(want, f).cpu()[hit]).abs().max())
              for f in ("n", "u", "v")) if hit.any() else 0.0
    assert err <= 1e-6, f"normal/uv err {err}"
    return {"rays": int(hit.numel()), "hits": int(hit.sum()),
            "t_rel": t_rel, "n_uv_abs": err,
            "t_bit_equal": float((tg == tw).float().mean())
            if hit.any() else 1.0}


def bit_contract(got, want) -> dict:
    """Hold a sweep kernel's hits to its plain version's on the same rays:
    t, n, u, v, mat and hit equal bit for bit (floats compared as their
    int32 bits), so the error is 0.0."""
    for f in ("t", "n", "u", "v", "mat", "hit"):
        g, w = getattr(got, f).cpu(), getattr(want, f).cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, f
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f"{f} differs from the plain version"
    return {"rays": int(want.hit.numel()), "hits": int(want.hit.sum()),
            "max_abs_err": 0.0}


def bounce_rays(o, d, h, seed: int = 0):
    """Bounce rays from a sweep's hits ``h`` of rays o, d: origins at the
    hit points (parked at 2.9e30 where the ray missed, as the wavefront
    parks finished lanes), directions on a hemisphere of the hit normal
    (even lanes leave the surface as a reflection does, odd lanes enter it
    as a refraction into a glass mesh does), per-ray tmin in [1e-4, 1e-2)
    and tmax in [1, 100), from a seeded numpy generator. Returns (o, d,
    tmin, tmax), contiguous on o's device."""
    P = o.shape[0]
    rs = np.random.RandomState(seed)
    r = rs.randn(P, 3)
    r = torch.from_numpy((r / np.linalg.norm(r, axis=1, keepdims=True))
                         .astype(np.float32)).to(o.device)
    side = torch.where(torch.arange(P, device=o.device) % 2 == 0, 1.0, -1.0)
    r = torch.where(((r * h.n).sum(1) * side < 0.0)[:, None], -r, r)
    p = torch.where(h.hit[:, None], o + h.t[:, None] * d, 2.9e30)
    lo = torch.from_numpy(rs.uniform(1e-4, 1e-2, P).astype(np.float32))
    hi = torch.from_numpy(rs.uniform(1.0, 100.0, P).astype(np.float32))
    return (p.contiguous(), r.contiguous(), lo.to(o.device),
            hi.to(o.device))


def primary_rays(scene, w: int, h: int, frame: int = TRACE_FRAME):
    """(o, d) of a scene's primary rays at w x h traced pixels."""
    params = ray_params(scene.default_pose, w, h, frame)
    return tuple(x.reshape(-1, 3).contiguous() for x in make_jittered_rays(
        None, w, h, frame, params=params))


def walk_cases(dev, w: int, h: int) -> dict:
    """The walk kernel's inputs, {name: (bvh, o, d, tmin, tmax)} on
    ``dev``: the bunny's primary rays at w x h and bounce rays from their
    hits; w * h rays from a seeded ring of origins around the ``make_knot``
    LBVH aimed at jittered triangle corners, and the same at a
    15,360-triangle knot's LBVH; ``exhibit_ring``'s primary rays at t = 0
    against its glass hero mesh and bounce rays from them."""
    cases = {}
    for name in ("bunny", "exhibit_ring"):
        scene = SCENE_BUILDERS[name]()
        scene = (scene.at_time(0.0) if hasattr(scene, "at_time")
                 else scene).to(dev)
        o, d = primary_rays(scene, w, h)
        prim = mesh_bvh.intersect_mesh(scene.mesh, o, d, 1e-3, INF,
                                       impl="plain")
        cases[f"{name}_primary"] = (scene.mesh, o, d, 1e-3, INF)
        cases[f"{name}_bounce"] = (scene.mesh, *bounce_rays(o, d, prim))
    # make_knot's LBVH (3,840 triangles, 2,047 nodes) and a 15,360-triangle
    # knot's (8,191 nodes: 262 KB of headers, more than the 128 KB the walk
    # stages in shared memory, so it reads the rest through L1).
    for name, knot in (("knot_lbvh", make_knot()),
                       ("large_lbvh", make_knot(seg_u=640))):
        soup = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
                (knot[:, 0], knot[:, 1], knot[:, 2],
                 np.arange(len(knot), dtype=np.int32) % 3)]
        rs = np.random.RandomState(1)
        P = w * h
        center = knot.reshape(-1, 3).mean(0)
        ring = rs.randn(P, 3)
        o = center + 4.0 * ring / np.linalg.norm(ring, axis=1, keepdims=True)
        aim = knot[rs.randint(0, len(knot), P), rs.randint(0, 3, P)]
        d = aim + 0.1 * rs.randn(P, 3) - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        cases[name] = (lbvh.build_lbvh(*soup),
                       torch.from_numpy(o.astype(np.float32)).to(dev),
                       torch.from_numpy(d.astype(np.float32)).to(dev),
                       1e-3, INF)
    return cases


def dda_cases(dev, w: int, h: int) -> dict:
    """The DDA kernel's inputs, {name: (world, o, d, tmin, tmax)} on
    ``dev``: ``voxel_cave``'s primary rays at w x h and bounce rays from
    their hits, and the primary rays of ``voxel_test``'s DDA form."""
    from yetanotherconsolegameengine_tpu_torch.scene.voxel_scenes import (
        build_voxel_test_scene)
    cave = SCENE_BUILDERS["voxel_cave"]().to(dev)
    o, d = primary_rays(cave, w, h, 2)
    prim = dda.intersect_voxels(cave.voxels, o, d, 1e-3, INF, impl="plain")
    room = build_voxel_test_scene(merge="dda").to(dev)
    return {"voxel_cave_primary": (cave.voxels, o, d, 1e-3, INF),
            "voxel_cave_bounce": (cave.voxels, *bounce_rays(o, d, prim)),
            "voxel_test_dda": (room.voxels, *primary_rays(room, w, h),
                               1e-3, INF)}


# The DDA stress grid, in cells (x, y, z): a floor (y < 4), a wall
# (z >= 20) and a pillar (x 32-33, y 4-11, z < 20), so that the cells at
# y = 4, z = 19 and x = 31 lie at distance 1 (jump 0).
STRESS_DIMS = (40, 16, 24)
STRESS_H = (1.0, 0.5, 2.0, 0.3)    # 0.3: no exact reciprocal, IEEE division


def dda_stress_cases(dev, n: int) -> dict:
    """The DDA kernel's stress inputs, {f"stress_h{h}": (world, o, d,
    tmin, tmax)} on ``dev`` for each voxel size of ``STRESS_H``: ``n`` rays
    from a seeded numpy generator, eight families taken in turn. Rays that
    graze the floor or the wall one cell a round through distance-1 cells
    (20 to 40 rounds) and end in it or in the pillar after any number of
    rounds; rays that rise off the floor (a jump ends a run of jump-0
    rounds); rays that leave the grid along the floor, or stop at a per-ray
    tmax; rays parallel to two axes or to one; rays from outside the grid
    and rays from inside a solid cell."""
    nx, ny, nz = STRESS_DIMS
    cells = np.zeros(STRESS_DIMS, np.int32)
    cells[:, :4, :] = 1
    cells[:, :, 20:] = 2
    cells[32:34, 4:12, :20] = 3
    rs = np.random.RandomState(11)
    o = np.zeros((n, 3))
    d = np.zeros((n, 3))
    tmax = np.full(n, np.float32(INF))
    u = rs.uniform(size=(n, 4))
    for i in range(n):
        a, b, c, e = u[i]
        fam = i % 8
        if fam == 0:     # along x over the floor, sinking into it or on
            o[i] = (1 + 5 * a, 4.05 + 0.9 * b, 2 + 15 * c)
            d[i] = (1.0, -0.04 * e, 0.04 * (b - 0.5))
        elif fam == 1:   # along x beside the wall, turning into it
            o[i] = (1 + 8 * a, 6 + 8 * b, 19.05 + 0.9 * c)
            d[i] = (1.0, 0.03 * (b - 0.5), 0.05 * e)
        elif fam == 2:   # rising off the floor: jumps cut the runs
            o[i] = (1 + 8 * a, 4.05 + 0.9 * b, 2 + 15 * c)
            d[i] = (1.0, 0.02 + 0.3 * e, 0.1 * (c - 0.5))
        elif fam == 3:   # out of the grid along the floor (-x or -z)
            o[i] = (1 + 8 * a, 4.05 + 0.9 * b, 1 + 6 * c)
            d[i] = ((-1.0, 0.01 * (e - 0.5), 0.05 * (b - 0.5)) if e < 0.5
                    else (0.05 * (b - 0.5), 0.01 * (e - 0.5), -1.0))
        elif fam == 4:   # along the floor, stopped by tmax
            o[i] = (1 + 5 * a, 4.05 + 0.9 * b, 2 + 15 * c)
            d[i] = (1.0, -0.01 * e, 0.02 * (b - 0.5))
            tmax[i] = 2.0 + 20.0 * e
        elif fam == 5:   # parallel to two axes, or to one
            o[i] = (1 + 30 * a, 4.05 + 0.9 * b, 1 + 18 * c)
            k = int(4 * e)
            d[i] = [(1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.8, 0.0, 0.6),
                    (0.6, -0.05, 0.0)][k]
        elif fam == 6:   # from outside the grid box, into the floor layer
            o[i] = (-3 - 4 * a, 4.05 + 0.9 * b, 2 + 15 * c)
            d[i] = (1.0, -0.02 * e, 0.02 * (b - 0.5))
        else:            # from inside a solid cell (the floor)
            o[i] = (1 + 30 * a, 0.5 + 2.5 * b, 1 + 18 * c)
            d[i] = (c - 0.5, e - 0.5, b - 0.5)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cases = {}
    for h in STRESS_H:
        origin = np.float32([-2.5, -1.0, 0.5])
        w = dda.build_voxel_world(cells, origin, h, device=dev)
        scale = np.float32(h)
        oo = (origin + o.astype(np.float32) * scale).astype(np.float32)
        hi = tmax.copy()
        hi[tmax < INF] *= scale
        cases[f"stress_h{h}"] = (
            w, torch.from_numpy(oo).to(dev),
            torch.from_numpy(d.astype(np.float32)).to(dev),
            torch.full((n,), 1e-3, device=dev) * float(scale),
            torch.from_numpy(hi).to(dev))
    return cases


# The primitive kernel's stress tables: every type, with rows that tie in t
# within a type (twins: the first row wins) and across types (a rect and a
# disk on one plane, a disk and a plane: the earlier type wins), a box and
# a cylinder that rays start inside, and rims and edges for grazing rays.
PRIM_FLOOR = (-8.0, 8.0, -12.0, 4.0)       # the floor rect's x and z extents
PRIM_LEDGE = (1.0, 3.0, -4.0, -2.0, 0.5)   # a rect's x, z extents and y
PRIM_DISK = ((2.0, 0.5, -3.0), 1.0)        # a disk on the ledge's plane
PRIM_POOL = ((12.0, -2.0, -8.0), 3.0)      # a disk on the ground plane
PRIM_BOX = ((5.0, 0.0, -2.0), (7.0, 2.0, 0.0))
PRIM_CYL = ((-5.0, 0.0, -3.0), 1.0, 0.0, 3.0)


def prim_stress_scene():
    """A scene of every primitive type built for the primitive kernel's
    edge cases (``PRIM_*`` above); each row its own material, so the
    winner's ``mat`` names the row."""
    from yetanotherconsolegameengine_tpu_torch.scene.materials import (
        Material)
    from yetanotherconsolegameengine_tpu_torch.scene.tables import (
        SceneBuilder)
    b = SceneBuilder("prim_stress")
    mats = iter(Material.solid((0.02 * k, 0.5, 0.5)) for k in range(1, 64))
    b.add_sphere((0.0, 1.0, -5.0), 1.0, next(mats))
    b.add_sphere((0.0, 1.0, -5.0), 1.0, next(mats))          # its twin
    b.add_sphere((3.0, 1.0, -6.0), 0.5, next(mats))
    b.add_box((-3.0, 0.0, -7.0), (-1.0, 2.0, -5.0), next(mats))
    b.add_box(*PRIM_BOX, next(mats))
    x0, x1, z0, z1 = PRIM_FLOOR
    b.add_xz_rect(x0, x1, z0, z1, 0.0, next(mats))
    b.add_xz_rect(x0, x1, z0, z1, 0.0, next(mats))          # its twin
    b.add_xy_rect(x0, x1, 0.0, 6.0, -12.0, next(mats))
    b.add_xz_rect(-3.0, -1.0, -7.0, -5.0, 2.0, next(mats))   # on a box top
    lx0, lx1, lz0, lz1, ly = PRIM_LEDGE
    b.add_xz_rect(lx0, lx1, lz0, lz1, ly, next(mats))
    b.add_yz_rect(0.0, 2.0, -10.0, -8.0, -7.0, next(mats))
    (cx, _, cz), r, y0, y1 = PRIM_CYL
    b.add_cylinder((cx, 0.0, cz), r, y0, y1, True, next(mats))
    b.add_cylinder((4.0, 0.0, -8.0), 0.7, 0.0, 2.0, False, next(mats))
    b.add_cylinder((-2.0, 0.0, -10.0), 0.5, 0.5, 1.5, True, next(mats))
    b.add_disk(PRIM_DISK[0], (0.0, 1.0, 0.0), PRIM_DISK[1], next(mats))
    b.add_disk(PRIM_POOL[0], (0.0, 1.0, 0.0), PRIM_POOL[1], next(mats))
    b.add_disk((-6.0, 2.0, -9.0), (0.3, 0.5, 1.0), 1.2, next(mats))
    b.add_plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0), next(mats))
    b.add_plane((0.0, 0.0, -20.0), (0.05, 0.1, 1.0), next(mats))
    b.add_triangle((-2.0, 3.0, -10.0), (2.0, 3.0, -10.0), (0.0, 5.0, -10.0),
                   next(mats))
    b.add_triangle((-4.0, 0.0, -19.0), (4.0, 0.0, -19.0), (0.0, 6.0, -19.0),
                   next(mats))
    b.add_light((0.0, 5.0, -4.0), (1.0, 1.0, 1.0), 10.0)
    b.set_camera((0.0, 2.0, 3.0))
    return b.build()


def _unit(v):
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _nudge(x, rs):
    """``x`` (float32) moved by one ulp up or down, or kept, at random."""
    x = x.astype(np.float32)
    step = rs.randint(-1, 2, x.shape)
    out = np.where(step > 0, np.nextafter(x, np.float32(np.inf)), x)
    return np.where(step < 0, np.nextafter(x, np.float32(-np.inf)), out)


def _edge_points(x0, x1, z0, z1, y, k, s):
    """Points on the edges of the rect [x0, x1] x [z0, z1] at height y:
    on edge k (x = x0, x = x1, z = z0, z = z1) at fraction s along it."""
    along_x, along_z = x0 + s * (x1 - x0), z0 + s * (z1 - z0)
    full = lambda v: np.full(s.shape, v)
    return np.stack([np.choose(k, [full(x0), full(x1), along_x, along_x]),
                     full(y),
                     np.choose(k, [along_z, along_z, full(z0), full(z1)])],
                    1)


def prim_stress_rays(n: int, seed: int) -> dict:
    """{name: (o, d, tmin, tmax)} of ``n`` numpy rays each at the stress
    scene, tmin/tmax numbers or (n,) arrays: rays from above the floor in
    every direction (per-lane bounds), every other one parked at 2.9e30 as
    the wavefront parks a finished lane; rays starting inside the box and
    the cylinder; rays aimed at the floor's and the ledge's edges and the
    disks' rims with the aim moved by an ulp, and rays within 1e-6 of
    parallel to the floor; rays straight down onto the twins and the
    shared planes."""
    rs = np.random.RandomState(seed)
    f32 = np.float32
    out = {}
    o = rs.uniform((-8.0, 0.2, -14.0), (8.0, 6.0, 6.0), (n, 3))
    d = _unit(rs.randn(n, 3))
    lo = rs.uniform(1e-4, 1e-2, n).astype(f32)
    hi = rs.uniform(1.0, 100.0, n).astype(f32)
    out["stress_general"] = (o, d, lo, hi)
    parked = np.where((np.arange(n) % 2 == 0)[:, None], o, 2.9e30)
    out["stress_parked"] = (parked, d, 1e-3, hi)
    (bmin, bmax), ((cx, _, cz), r, y0, y1) = PRIM_BOX, PRIM_CYL
    in_box = rs.uniform(bmin, bmax, (n, 3))
    ang, rad = rs.uniform(0.0, 2 * np.pi, n), r * np.sqrt(rs.uniform(0, 1, n))
    in_cyl = np.stack([cx + rad * np.cos(ang), rs.uniform(y0, y1, n),
                       cz + rad * np.sin(ang)], 1)
    inside = np.where((np.arange(n) % 2 == 0)[:, None], in_box, in_cyl)
    out["stress_inside"] = (inside, _unit(rs.randn(n, 3)), lo, INF)
    # Edges and rims: the floor's x and z edges, the ledge's, the disks'.
    k = rs.randint(0, 4, n)
    s = rs.uniform(0.0, 1.0, n)
    floor_edge = _edge_points(*PRIM_FLOOR, 0.0, k, s)
    ledge_edge = _edge_points(*PRIM_LEDGE, k, s)
    rims = []
    for (c, rr) in (PRIM_DISK, PRIM_POOL):
        a = rs.uniform(0.0, 2 * np.pi, n)
        rims.append(np.stack([c[0] + rr * np.cos(a), np.full(n, c[1]),
                              c[2] + rr * np.sin(a)], 1))
    aim = np.choose(rs.randint(0, 4, n)[:, None],
                    [floor_edge, ledge_edge, rims[0], rims[1]])
    src = rs.uniform((-8.0, 1.0, -14.0), (8.0, 6.0, 6.0), (n, 3))
    d = _unit(_nudge(aim, rs).astype(np.float64) - src)
    out["stress_edges"] = (src, d, 1e-3, hi)
    # Within 1e-6 of parallel to the floor, about the intersectors' 1e-8
    # and 1e-6 thresholds: d.y from {0, +-1e-9, +-1e-8, +-1e-7, +-1e-6}.
    flat = _unit(np.stack([rs.randn(n), np.zeros(n), rs.randn(n)], 1))
    flat[:, 1] = rs.choice([0.0, 1e-9, -1e-9, 1e-8, -1e-8, 1e-7, -1e-7,
                            1e-6, -1e-6], n)
    src = np.stack([rs.uniform(-8, 8, n), rs.choice([0.0, 0.5, 1e-7], n),
                    rs.uniform(-12, 4, n)], 1)
    out["stress_grazing"] = (src, flat, lo, INF)
    # Straight down onto the sphere twins, the floor twins, the ledge over
    # the disk and the pool on the ground plane.
    tgt = np.choose(rs.randint(0, 4, n)[:, None], [
        np.stack([rs.uniform(-0.9, 0.9, n), np.zeros(n),
                  rs.uniform(-5.9, -4.1, n)], 1),
        np.stack([rs.uniform(-8, 8, n), np.zeros(n), rs.uniform(0.5, 4, n)],
                 1),
        np.stack([rs.uniform(1.0, 3.0, n), np.zeros(n),
                  rs.uniform(-4.0, -2.0, n)], 1),
        np.stack([rs.uniform(9.0, 15.0, n), np.zeros(n),
                  rs.uniform(-11.0, -5.0, n)], 1)])
    src = tgt + np.array([0.0, 8.0, 0.0])
    out["stress_ties"] = (src, np.tile([0.0, -1.0, 0.0], (n, 1)), lo, hi)
    return {k: (np.asarray(o, f32), np.asarray(d, f32), a, b)
            for k, (o, d, a, b) in out.items()}


def prim_stress_tables(scene, extra: int, seed: int = 7):
    """``scene`` with ``extra`` seeded spheres and as many triangles after
    its own rows (their materials the scene's first)."""
    rs = np.random.RandomState(seed)
    c = rs.uniform((-8, 0, -12), (8, 6, 4), (extra, 3)).astype(np.float32)
    a = rs.uniform((-8, 0, -12), (8, 6, 4), (extra, 3)).astype(np.float32)
    e1 = rs.uniform(-0.5, 0.5, (extra, 3)).astype(np.float32)
    e2 = rs.uniform(-0.5, 0.5, (extra, 3)).astype(np.float32)
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    new = {"spheres": dict(center=c, radius=rs.uniform(0.05, 0.3, extra)),
           "triangles": dict(a=a, e1=e1, e2=e2, n=nrm)}
    out = {}
    for name in ("spheres", "triangles"):
        tb = getattr(scene, name)
        n0 = int(tb.mask.sum())
        rows = n0 + extra
        nb = 1 << (rows - 1).bit_length()
        cols = {}
        for f in dataclasses.fields(tb):
            x = getattr(tb, f.name)[:n0]
            add = (torch.from_numpy(np.asarray(new[name][f.name],
                                               np.float32))
                   if f.name in new[name] else
                   torch.full((extra,), True) if f.name == "mask" else
                   torch.zeros((extra,), dtype=x.dtype))
            x = torch.cat([x, add.to(x.dtype)])
            pad = torch.zeros((nb - rows, *x.shape[1:]), dtype=x.dtype)
            cols[f.name] = torch.cat([x, pad]).contiguous()
        out[name] = dataclasses.replace(tb, **cols)
    return dataclasses.replace(scene, **out)


PRIM_SCENES = ("museum", "cornell", "demo_random", "texture_test",
               "exhibit_ring_t0", "exhibit_ring_t1.3")
PRIM_STRESS = ("general", "parked", "inside", "edges", "grazing", "ties")


def prim_case_names() -> list:
    """The names of ``prim_cases``' cases, in its order."""
    from yetanotherconsolegameengine_tpu_torch.scene.tables import (
        PRIMITIVE_TABLES)
    return ([f"{s}_{k}" for s in PRIM_SCENES
             for k in ("primary", "bounce", "shadow")]
            + [f"stress_{k}" for k in PRIM_STRESS]
            + [f"stress_{t}_alone" for t in PRIMITIVE_TABLES]
            + ["stress_all_empty", "stress_many_rows"])


def prim_cases(dev, w: int, h: int) -> dict:
    """The primitive kernel's inputs, {name: (scene, o, d, tmin, tmax)} on
    ``dev``, tmin/tmax numbers or (P,) tensors. ``museum``, ``cornell``,
    ``demo_random``, ``texture_test`` and ``exhibit_ring`` at t = 0 and
    1.3: primary rays at w x h, bounce rays from their plain hits
    (``bounce_rays``: per-lane bounds, misses parked at 2.9e30) and shadow
    rays from the hits to the first light (tmin 1e-3, tmax the distance,
    misses parked). The stress scene with ``prim_stress_rays``' w * h rays
    a case; its general rays against each table alone, against seven empty
    tables, and against spheres and triangles grown by 600 rows each."""
    from yetanotherconsolegameengine_tpu_torch.scene.tables import (
        PRIMITIVE_TABLES, SceneBuilder)
    cases = {}
    ring = SCENE_BUILDERS["exhibit_ring"]()
    scenes = [(n, SCENE_BUILDERS[n]()) for n in PRIM_SCENES[:4]]
    scenes += [(PRIM_SCENES[4], ring.at_time(0.0)),
               (PRIM_SCENES[5], ring.at_time(1.3))]
    for name, scene in scenes:
        scene = scene.to(dev)
        o, d = primary_rays(scene, w, h)
        cases[f"{name}_primary"] = (scene, o, d, 1e-3, INF)
        hit = intersect_primitives(scene, o, d, 1e-3, INF)
        cases[f"{name}_bounce"] = (scene, *bounce_rays(o, d, hit))
        p = o + hit.t[:, None] * d
        to = scene.lights.pos[0] - p
        dist = torch.sqrt((to * to).sum(1))
        so = torch.where(hit.hit[:, None], p, 2.9e30).contiguous()
        cases[f"{name}_shadow"] = (scene, so, (to / dist[:, None])
                                   .contiguous(), 1e-3, dist)
    stress = prim_stress_scene()
    as_dev = lambda x: (torch.from_numpy(np.asarray(x, np.float32)).to(dev)
                        if isinstance(x, np.ndarray) else x)
    rays = {k: tuple(as_dev(x) for x in v)
            for k, v in prim_stress_rays(w * h, 5).items()}
    assert list(rays) == [f"stress_{k}" for k in PRIM_STRESS]
    for k, r in rays.items():
        cases[k] = (stress.to(dev), *r)
    general = rays["stress_general"]
    empty = SceneBuilder("empty").build()
    for keep in PRIMITIVE_TABLES:
        alone = dataclasses.replace(stress, **{
            t: getattr(empty, t) for t in PRIMITIVE_TABLES if t != keep})
        cases[f"stress_{keep}_alone"] = (alone.to(dev), *general)
    cases["stress_all_empty"] = (dataclasses.replace(stress, **{
        t: getattr(empty, t) for t in PRIMITIVE_TABLES}).to(dev), *general)
    cases["stress_many_rows"] = (prim_stress_tables(stress, 600)
                                     .to(dev), *general)
    return cases


def sweep_kernel_cases(cases, key: str, sweep, launch, grid_args, count,
                       bound) -> dict:
    """Phases 11 and 15 on each case (grid, o, d, tmin, tmax) of
    ``cases``: ``sweep`` (the path's entry; impl None takes the kernel
    ``key``, one launch) bit-equal to its plain version on the card; the
    kernel's device time (``launch`` alone on the case's tensors,
    torch.profiler) and the sweep's CUDA-event time; the work these rays
    need (``count``: the plain loop's active lanes summed over its rounds)
    and the least time ``bound`` gives it."""
    res = {}
    for name, (grid, o, d, lo, hi) in cases.items():
        before = kernels.LAUNCHES[key]
        got = sweep(grid, o, d, lo, hi)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[key] == before + 1, f"{name}: launches"
        err = bit_contract(got, sweep(grid, o, d, lo, hi, impl="plain"))
        kargs = (*grid_args(grid), o, d, _lanes(lo, o), _lanes(hi, o))
        ms = kernel_ms(lambda: launch(*kargs), 20)
        ev = cuda_ms(lambda: sweep(grid, o, d, lo, hi), 20)
        work = count(grid, o, d, lo, hi)
        least, by = bound(work, o.shape[0])
        res[name] = dict(err, ms=ms, event_ms=ev, bound_ms=least,
                         bound_by=by, share=least / ms, work=work)
    return res


def prim_bound(scene, o, tmin, tmax):
    """(least ms, bound by) of a primitive sweep of rays ``o`` over
    ``scene``'s tables: every ray tests every masked-in row
    (``PRIM_ROW_OPS``), and moves ``PRIM_RAY_BYTES`` and its per-lane
    bounds; the tables' columns are read once."""
    P = o.shape[0]
    ops = P * sum(int(getattr(scene, name).mask.sum()) * n
                  for name, n in PRIM_ROW_OPS.items())
    lanes = sum(isinstance(x, torch.Tensor) for x in (tmin, tmax))
    table = sum(x.numel() * x.element_size()
                for x in intersect.prim_args(scene, o.device).cols)
    return roofline(ops, P * (PRIM_RAY_BYTES + 4 * lanes) + table)


def prim_phase(dev, card) -> dict:
    """Phase 25: the primitive kernel (``intersect.sweep_primitives``)
    against its plain version (``intersect_primitives``) on every
    primitive sweep of a museum frame at 160x90 (the frame eager, so each
    of its 27 sweeps is recorded; t, n, u, v, mat and hit bit for bit),
    then a sweep of 28,800 rays and one of 230,400 (a shadow sweep's
    lanes) of that frame timed: the kernel's device time (torch.profiler)
    and its CUDA-event time, the plain loop's CUDA-event time, the bound
    and the share; then the card tests' cases (``prim_cases`` at 64x48)
    bit for bit."""
    scene = SCENE_BUILDERS["museum"]()
    r = RaytraceRenderer(scene, FB_W, FB_H, device=dev)
    kernels.reset_launches()
    calls = record_calls(lambda: r.render_many(1), intersect,
                         "sweep_primitives")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["prim"] == len(calls) > 0, "prim launches"
    frame = [bit_contract(out, intersect_primitives(*args))
             for args, _, out in calls]
    widths = sorted({args[1].shape[0] for args, _, _ in calls})
    assert widths == [FB_W * FB_H * 2, FB_W * FB_H * 2 * 8], widths
    timing = {}
    for P in widths:
        args = next(a for a, _, _ in calls if a[1].shape[0] == P)
        least, by = prim_bound(*args[:2], *args[3:])
        ms = kernel_ms(lambda: intersect.sweep_primitives(*args), 20)
        timing[P] = {
            "ms": ms,
            "event_ms": cuda_ms(lambda: intersect.sweep_primitives(*args),
                                20),
            "plain_ms": cuda_ms(lambda: intersect_primitives(*args), 5),
            "bound_ms": least, "bound_by": by, "share": least / ms,
            "tensor_bounds": [isinstance(x, torch.Tensor)
                              for x in args[3:]]}
    cases = {name: bit_contract(
        intersect.sweep_primitives(*case), intersect_primitives(*case))
        for name, case in prim_cases(dev, 64, 48).items()}
    print(f"phase 25 {card} primitive kernel vs the plain loop: the "
          f"{len(frame)} sweeps of a museum {FB_W}x{FB_H} frame (widths "
          f"{widths}) bit-equal, {sum(f['hits'] for f in frame)} hits; "
          f"{len(cases)} cases at 64x48 bit-equal; ms per sweep (device "
          f"time | CUDA events | plain loop by events), bound, share: "
          f"{json.dumps(timing)}", flush=True)
    return {"frame": frame, "timing": timing, "cases": cases,
            "launches": len(calls)}


def glue_case_names() -> list:
    """The names of ``glue_cases``' cases, in its order."""
    return ["kc256_nearest", "kc256_nearest_unsorted_lanes",
            "kc256_any_hit_lanes", "kc512_bias_nearest",
            "kc512_bias_any_hit_unsorted", "kc512_inf_scalar",
            "kc256_grazing_edges", "kc256_zero_windows",
            "many_clusters_nearest", "many_clusters_any_hit_unsorted",
            "no_rays"]


def glue_rays(bounds, n: int, seed: int):
    """n rays (numpy o, d) at a mesh of box ``bounds`` (2, 3): from a
    sphere round it at points of the box, a quarter from inside the box
    in any direction; lanes 0 mod 17 parked at 2.9e30, and lanes with
    zero and -0 direction components, a NaN origin, a NaN and an infinite
    direction, one starting past the box pointing away."""
    rng = np.random.RandomState(seed)
    lo, hi = (np.asarray(x, np.float64) for x in bounds)
    c, ext = (lo + hi) / 2, hi - lo
    r = float(np.linalg.norm(ext))
    u = rng.normal(size=(n, 3))
    o = c + u / np.linalg.norm(u, axis=1, keepdims=True) * r
    d = lo + rng.uniform(size=(n, 3)) * ext - o
    q = n // 4
    o[:q] = lo + rng.uniform(size=(q, 3)) * ext
    d[:q] = rng.normal(size=(q, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[::17] = 2.9e30
    if n > 12:
        o[5:7] = c + [0.01, 0.02, r]
        d[5] = [0.0, 0.0, -1.0]
        d[6] = [-0.0, 0.0, -1.0]
        o[8, 1] = np.nan
        d[9, 0] = np.nan
        o[10], d[10] = c, [np.inf, 0.0, 0.0]
        o[11], d[11] = c + [2 * r, 0.0, 0.0], [1.0, 0.0, 0.0]
    return o.astype(np.float32), d.astype(np.float32)


def glue_edge_rays(mc, copies: int = 64):
    """``copies`` equal rays a cluster of ``mc`` (in the caller's order, a
    sub-bundle each at 64) that pass its box's edge at max x, min y, at
    its middle, along (1, 1, 0) / sqrt(2), from 1 before it: cluster i's
    ray moved off the box by (i mod 4) * 6.25e-5, so the box's y interval
    starts 0, 1.25e-4, 2.5e-4 or 3.75e-4 after its x interval ends, about
    the cull's slack (2e-4 at t = 1); at 0 rounding leaves a few ulp
    either way."""
    lo = mc.cbmin.cpu().numpy().astype(np.float64)
    hi = mc.cbmax.cpu().numpy().astype(np.float64)
    edge = np.stack([hi[:, 0], lo[:, 1], (lo[:, 2] + hi[:, 2]) / 2], 1)
    d = np.float32([1.0, 1.0, 0.0]) / np.float32(np.sqrt(2.0))
    off = (np.arange(len(edge)) % 4 * 6.25e-5)[:, None] * [1.0, -1.0, 0.0]
    o = (edge + off / np.sqrt(2.0) - d.astype(np.float64)).astype(np.float32)
    return (np.repeat(o, copies, 0),
            np.repeat(d[None], len(o) * copies, 0))


def glue_grid(n: int = 91):
    """An n x n grid of unit-area-split quads in the plane z = 0 over
    [-4, 4]^2 (2 n^2 triangles): at kc 4, more clusters than the cull's
    sort holds."""
    t = np.linspace(-4.0, 4.0, n + 1, dtype=np.float32)
    x0, y0 = np.meshgrid(t[:-1], t[:-1], indexing="ij")
    x1, y1 = np.meshgrid(t[1:], t[1:], indexing="ij")
    z = np.zeros_like(x0)
    a = np.stack([x0, y0, z], -1).reshape(-1, 3)
    b = np.stack([x1, y0, z], -1).reshape(-1, 3)
    c = np.stack([x1, y1, z], -1).reshape(-1, 3)
    e = np.stack([x0, y1, z], -1).reshape(-1, 3)
    return np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, e], 1)])


def glue_cases(dev) -> dict:
    """The cull and resolve kernels' inputs, {name: (mc, o, d, tmin, tmax,
    any_hit, presort)} on ``dev``: a 18,432-triangle stand-in dragon in
    cluster tables of kc 256 (72 clusters) and kc 512 (36, with a proxy
    set's t_bias), and a plane of 16,562 triangles at kc 4 (4,141
    clusters, past the cull's sort), under 1,000 or 600 ``glue_rays``
    (a padded tile), nearest and any-hit, binned and in the caller's
    order, bounds as numbers (1e-3 and 3e38; 0 and inf) or per lane (some
    windows negative or empty; a proxy set's tmin clamped at its t_bias,
    as ``intersect_scene`` gives it); ``glue_edge_rays`` about the cull's
    slack; a tile starting inside the boxes with windows ending at 0; and
    no rays at all."""
    from yetanotherconsolegameengine_tpu_torch.ops.mesh_clusters import (
        build_clusters)
    tris = transform_mesh(make_dragon(192, 48), normalize=True, scale=2.6)
    mat = (np.arange(len(tris)) % 5).astype(np.int32)
    grid = glue_grid()

    def mesh(t, m, **kw):
        return build_clusters(t[:, 0], t[:, 1], t[:, 2], m, **kw).to(dev)

    m256 = mesh(tris, mat)
    m512 = mesh(tris, mat, kc=512, t_bias=0.02)
    many = mesh(grid, np.zeros(len(grid), np.int32), kc=4)
    assert many.n_clusters > mesh_clusters.SORT_MAX

    def rays(mc, n, seed):
        o, d = glue_rays(mc.bounds.cpu().numpy(), n, seed)
        return (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev))

    def lanes(n, seed):
        rng = np.random.RandomState(seed)
        lo = rng.uniform(1e-3, 0.5, n).astype(np.float32)
        lo[::13] = lo[11] = -50.0
        hi = rng.uniform(0.5, 12.0, n).astype(np.float32)
        hi[1::11] = lo[1::11] * 0.5
        hi[::19] = np.inf
        return (torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev))

    def biased(mc, o, seed):
        lo = torch.clamp(torch.full((o.shape[0],), 1e-3, device=dev),
                         min=mc.t_bias)
        return lo, lanes(o.shape[0], seed)[1]

    r256 = rays(m256, 1000, 1)
    r512 = rays(m512, 1000, 2)
    edges = tuple(torch.from_numpy(x).to(dev) for x in glue_edge_rays(m256))
    # A first tile from inside the box with windows ending at 0: its list
    # may take no box, though it starts in them.
    inside = tuple(torch.from_numpy(x[:512]).to(dev)
                   for x in glue_rays(m256.bounds.cpu().numpy(), 1024, 9))
    zero = torch.cat([torch.zeros(256, device=dev),
                      torch.full((256,), 5.0, device=dev)])
    # The plane: rays from above at 49 small patches of it.
    rng = np.random.RandomState(3)
    go = np.concatenate([rng.uniform(-0.3, 0.3, (600, 2)),
                         np.full((600, 1), 3.0)], 1)
    aim = np.concatenate([rng.uniform(-3.0, 3.0, (600, 2)).round(0)
                          + rng.uniform(-0.2, 0.2, (600, 2)),
                          np.zeros((600, 1))], 1)
    gd = (aim - go) / np.linalg.norm(aim - go, axis=1, keepdims=True)
    go[::17] = 2.9e30
    rg = tuple(torch.from_numpy(x.astype(np.float32)).to(dev)
               for x in (go, gd))
    return {
        "kc256_nearest": (m256, *r256, 1e-3, INF, False, True),
        "kc256_nearest_unsorted_lanes": (m256, *r256, *lanes(1000, 4),
                                         False, False),
        "kc256_any_hit_lanes": (m256, *r256, *lanes(1000, 5), True, True),
        "kc512_bias_nearest": (m512, *r512, *biased(m512, r512[0], 6),
                               False, True),
        "kc512_bias_any_hit_unsorted": (m512, *r512,
                                        *biased(m512, r512[0], 7), True,
                                        False),
        "kc512_inf_scalar": (m512, *r512, 0.0, float("inf"), False, True),
        "kc256_grazing_edges": (m256, *edges, 1e-3, INF, False, False),
        "kc256_zero_windows": (m256, *inside, 1e-3, zero, False, False),
        "many_clusters_nearest": (many, *rg, 1e-3, INF, False, True),
        "many_clusters_any_hit_unsorted": (many, *rg, *lanes(600, 8), True,
                                           False),
        "no_rays": (m256, r256[0][:0], r256[1][:0], 1e-3, INF, False,
                    True),
    }


@contextlib.contextmanager
def patched(mod, attr: str, value):
    """``mod.attr`` set to ``value`` inside the block."""
    real = getattr(mod, attr)
    setattr(mod, attr, value)
    try:
        yield real
    finally:
        setattr(mod, attr, real)


def same_bits(got, want, what: str) -> None:
    """Tensors (or other values) equal, floats compared as int32 bits."""
    if not isinstance(want, torch.Tensor):
        assert got == want, what
        return
    g, w = got.cpu(), want.cpu()
    assert g.dtype == w.dtype and g.shape == w.shape, what
    if g.dtype == torch.float32:
        g, w = g.view(torch.int32), w.view(torch.int32)
    assert torch.equal(g, w), f"{what} differs from the torch twin"


def glue_contract(mc, o, d, tmin, tmax, any_hit: bool,
                  presort: bool) -> dict:
    """One cluster sweep through the cull and resolve kernels
    (``mesh_clusters._sweep_kernels``) against their torch twin
    (``_sweep``), K3 run once: the twin's K3 arguments (lens, ids,
    entry_t, the rays) bit-equal to the kernels', K3's result handed to
    both resolves; the Hit, steps and lens bit for bit. Returns (a report,
    K3's result)."""
    seen = []

    def k3(*args):
        seen.append((args, real(*args)))
        return seen[-1][1]

    def replay(*args):
        want, out = seen[0]
        for name, g, w in zip(("lens", "ids", "entry_t", "gmat", "rays",
                               "any_hit", "qmask"), args, want):
            same_bits(g, w, name)
        return out

    with patched(cluster_kernel, "trace_tiles", k3) as real:
        got, steps, lens = mesh_clusters._sweep_kernels(
            mc, o, d, tmin, tmax, any_hit, presort)
    with patched(cluster_kernel, "trace_tiles_plain", replay):
        want, w_steps, w_lens = mesh_clusters._sweep(
            mc, o, d, tmin, tmax, any_hit, presort)
    assert len(seen) == 1
    bit_contract(got, want)
    same_bits(steps, w_steps, "steps")
    same_bits(lens, w_lens, "lens")
    return {"rays": int(o.shape[0]), "hits": int(want.hit.sum()),
            "tiles": int(lens.shape[0]), "clusters": mc.n_clusters,
            "listed": int(lens.sum()), "max_abs_err": 0.0}, seen[0][1]


def glue_bound(mc, o, tmin, tmax, any_hit: bool, hits: int, listed: int):
    """(least ms, bound by) of one sweep's cull and resolve kernels, with
    ``listed`` entries over the tiles' lists: ``GLUE_*_BYTES`` over the
    card's bandwidth."""
    P = o.shape[0]
    n_tiles = -(-P // mesh_clusters.TILE)
    lanes = sum(isinstance(x, torch.Tensor) for x in (tmin, tmax))
    nbytes = (P * (GLUE_RAY_BYTES + 4 * lanes)
              + n_tiles * mesh_clusters.TILE * GLUE_LANE_BYTES
              + listed * GLUE_ENTRY_BYTES + n_tiles * 4
              + mc.n_clusters * GLUE_BOX_BYTES
              + (0 if any_hit else hits * GLUE_ROW_BYTES))
    return roofline(0, nbytes)


def glue_launches(launches: dict) -> int:
    """The cull and resolve kernels' launches in a run's launch counts."""
    return sum(launches[k] for k in ("cluster_prep", "cluster_cull",
                                     "cluster_resolve"))


def glue_phase(dev, card, frame, sets, cfg) -> dict:
    """Phase 7b: the cull and resolve kernels against their torch twin
    (``glue_contract``, bit for bit) on every cluster sweep of the
    dragon's frame (``frame(cfg)``: fine primary, LOD bounce, the
    any-hit shadow sweeps) and on its primary sweep of the full set,
    then each timed without K3 (its result replayed): the kernels' and
    the binning sort's device time (torch.profiler) and CUDA-event time,
    the twin's CUDA-event time, the least time (``glue_bound``) and the
    share; then ``glue_cases`` bit for bit."""
    def record(c):
        calls = []
        real = mesh_clusters.intersect_clusters

        def spy(mc, *args, **kw):
            calls.append((mc, tuple(x.clone() if isinstance(x, torch.Tensor)
                                    else x for x in args), dict(kw)))
            return real(mc, *args, **kw)
        with patched(mesh_clusters, "intersect_clusters", spy):
            frame(c)
        return calls

    calls = record(cfg)
    calls += record(dataclasses.replace(cfg, primary_mesh_lod=False))[:1]
    res = []
    for i, (mc, (o, d, lo, hi), kw) in enumerate(calls):
        any_hit, presort = kw.get("any_hit", False), kw.get("presort", True)
        err, out = glue_contract(mc, o, d, lo, hi, any_hit, bool(presort))

        def kernels_only():
            with patched(cluster_kernel, "trace_tiles", lambda *a: out):
                mesh_clusters._sweep_kernels(mc, o, d, lo, hi, any_hit,
                                             bool(presort))

        def twin_only():
            with patched(cluster_kernel, "trace_tiles_plain",
                         lambda *a: out):
                mesh_clusters._sweep(mc, o, d, lo, hi, any_hit,
                                     bool(presort))
        ms, ops = device_ms(kernels_only, 20)
        least, by = glue_bound(mc, o, lo, hi, any_hit, err["hits"],
                               err["listed"])
        res.append(dict(
            sweep=i, set=sets[id(mc.gmat)], kc=mc.kc, any_hit=any_hit,
            presort=bool(presort), **err, ms=ms, device_ops=ops,
            event_ms=cuda_ms(kernels_only, 20),
            plain_ms=cuda_ms(twin_only, 5), bound_ms=least, bound_by=by,
            share=least / ms))
    assert [r["set"] for r in res][-1] == "full"
    cases = {name: glue_contract(*case)[0]
             for name, case in glue_cases(dev).items()}
    frame_res = res[:-1]
    tot = {k: sum(r[k] for r in frame_res)
           for k in ("ms", "event_ms", "plain_ms", "bound_ms")}
    print(f"phase 7b {card} cull and resolve kernels vs their torch twin "
          f"on the {len(frame_res)} cluster sweeps of the dragon frame and "
          f"its full-set primary sweep, bit for bit; {len(cases)} cases "
          f"bit for bit; the frame's sweeps (device time | CUDA events | "
          f"twin by events) {tot['ms']:.5f} | {tot['event_ms']:.5f} | "
          f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.5f} ms; per "
          f"sweep {json.dumps(res)}", flush=True)
    return {"sweeps": res, "cases": cases, **tot}


def frame_times(first: int, n: int):
    """Times of frames first..first+n-1 of a dynamic scene at 30 fps."""
    return [(first + k) / 30.0 for k in range(n)]


def timed_frames(r, n: int, keys, warmup: int = 2, poses=None,
                 scene_fn=None) -> dict:
    """Warm up ``r`` for ``warmup`` frames, then time ``r.render_many(n)``
    (along ``poses`` when given; frames of ``scene_fn`` at 30 fps when
    given) with every launch count set to 0 just before and read just
    after; each kernel of ``keys`` must have launched."""
    dyn = {} if scene_fn is None else dict(scene_fn=scene_fn,
                                           times=frame_times(0, warmup))
    r.render_many(warmup, poses=None if poses is None else poses[:warmup],
                  **dyn)
    if scene_fn is not None:
        dyn["times"] = frame_times(warmup, n)
    torch.cuda.synchronize()
    kernels.reset_launches()
    mesh_bvh.STATS.clear()
    dda.STATS.clear()
    ms, wall, (grids, out) = timed(
        lambda: r.render_many(n, poses=poses, **dyn), n, r.device)
    launches = dict(kernels.LAUNCHES)
    for k in keys:
        assert launches[k] > 0, f"kernel {k} was not launched by the path"
    assert not mesh_bvh.STATS["rounds"] and not dda.STATS["rounds"], \
        "the plain BVH walk or DDA loop ran on the kernel path"
    fg = _np(grids[0])
    assert fg.shape == (n, r.fb_h, r.fb_w) and fg.min() >= 16
    assert np.isfinite(_np(out.top_rgb)).all()
    rays = int(out.rays_traced)
    return {"ms": ms, "host_ms": wall, "rays": rays,
            "mray_s": rays / ms / 1e3, "launches": launches,
            "bvh": dict(mesh_bvh.STATS), "dda": dict(dda.STATS)}


def idle_share(r, poses) -> dict:
    """Device busy time of ``r.render_many`` along ``poses`` (the summed
    durations of its device operations, torch.profiler) against its wall
    by CUDA events with the profiler off: (busy ms/frame, wall ms/frame,
    device operations per frame, idle share)."""
    n = len(poses)
    busy, ops = device_ms(lambda: r.render_many(n, poses=poses), 1, 1)
    wall = cuda_ms(lambda: r.render_many(n, poses=poses), 1, 1)
    return {"busy_ms": busy / n, "wall_ms": wall / n, "ops": ops / n,
            "idle_share": 1.0 - busy / wall}


def renderer_contract(scene, w, h, dev, frames: int = 4, cam=None,
                      scene_fn=None, ss: int = 1):
    """Kernel vs plain renderer on the card over ``frames`` frames at
    supersampling ``ss`` (from camera ``cam`` = (pos, yaw, pitch) when
    given; for a dynamic scene, frames of ``scene_fn`` at 30 fps with
    ``scene`` set as not static): RGB within 2e-3, ANSI flips under 0.5%,
    equal rays_traced. Returns (the errors, the kernel renderer)."""
    rk = RaytraceRenderer(scene, w, h, ss=ss, device=dev, impl="kernel")
    rp = RaytraceRenderer(scene, w, h, ss=ss, device=dev, impl="plain")
    dyn = {}
    if scene_fn is not None:
        dyn = dict(scene_fn=scene_fn, times=frame_times(0, frames))
        for r in (rk, rp):
            r.set_scene(scene, static=False)
    if cam is not None:
        rk.set_camera(*cam)
        rp.set_camera(*cam)
    gk, ok_ = rk.render_many(frames, **dyn)
    gp, op_ = rp.render_many(frames, **dyn)
    err = max(np.abs(_np(ok_.top_rgb) - _np(op_.top_rgb)).max(),
              np.abs(_np(ok_.bot_rgb) - _np(op_.bot_rgb)).max())
    flips = float(np.mean([(_np(a) != _np(b)).mean()
                           for a, b in zip(gk, gp)]))
    assert err <= 2e-3 and flips < 0.005, (err, flips)
    assert int(ok_.rays_traced) == int(op_.rays_traced)
    return {"rgb": float(err), "ansi_flips": flips,
            "rays": int(ok_.rays_traced)}, rk


def real_blockers(args, win) -> bool:
    """Every winner of a K3 sweep is a real blocker of its ray: its
    plain-arithmetic t (``cluster_kernel.winner_t``) beats tmin strictly
    and tinit by key, and its barycentric test passes."""
    _, _, _, gmat, rays, _, qmask = args
    kc = gmat.shape[2]
    f = torch.clamp(win, min=0).long()
    g = gmat[f // kc, :, f % kc]                         # (P, 12)
    r = rays
    ou = ((g[:, 0] * r[:, 0] + g[:, 1] * r[:, 1]) + g[:, 2] * r[:, 2]) \
        + g[:, 3]
    du = (g[:, 0] * r[:, 3] + g[:, 1] * r[:, 4]) + g[:, 2] * r[:, 5]
    ov = ((g[:, 4] * r[:, 0] + g[:, 5] * r[:, 1]) + g[:, 6] * r[:, 2]) \
        + g[:, 7]
    dv = (g[:, 4] * r[:, 3] + g[:, 5] * r[:, 4]) + g[:, 6] * r[:, 5]
    t = cluster_kernel.winner_t(gmat, rays, win)
    u = ou + t * du
    v = ov + t * dv
    key = cluster_kernel.key_of
    ok = ((u >= -1e-3) & (v >= -1e-3) & ((1.0 - u) - v >= -1e-3)
          & (t > r[:, 6]) & (key(t, qmask) < key(r[:, 7].contiguous(), qmask)))
    return bool((ok | (win < 0)).all())


def sweep_contract(got, ref, args) -> dict:
    """Hold K3's (t, winner) to its plain version. Nearest mode: winners
    equal and t bit-equal. Any-hit mode (every hit ends the ray, any
    blocker may win): equal hit masks, and every winner a real blocker.
    Entries tested are reported, not compared: the split sweep may test
    more than the serial walk."""
    t, win, steps = (x.cpu().numpy() for x in got)
    rt, rwin, rsteps = (x.cpu().numpy() for x in ref)
    hit = rwin >= 0
    np.testing.assert_array_equal(win >= 0, hit, err_msg="hit masks")
    if args[5]:
        assert real_blockers(args, got[1]), "any-hit winner is no blocker"
    else:
        np.testing.assert_array_equal(win, rwin, err_msg="winners")
        np.testing.assert_array_equal(t.view(np.int32), rt.view(np.int32),
                                      err_msg="t bits")
    return {"rays": int(win.size), "hits": int(hit.sum()),
            "same_winners": bool(np.array_equal(win, rwin)),
            "t_abs": None if args[5] else float(np.abs(t[hit] - rt[hit]).max())
            if hit.any() else 0.0,
            "entries": int(steps.sum()), "entries_serial": int(rsteps.sum())}


def record_calls(fn, mod, attr: str):
    """Run ``fn`` with ``mod.attr`` wrapped; returns [(positional
    arguments, keyword arguments, result), ...] of every call it made."""
    calls = []
    real = getattr(mod, attr)

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out

    setattr(mod, attr, spy)
    try:
        fn()
    finally:
        setattr(mod, attr, real)
    return calls


def record_sweeps(fn):
    """Run ``fn`` and return [(K3 arguments, K3 result), ...] of every
    cluster sweep it launched."""
    return [(args, out) for args, _, out in
            record_calls(fn, cluster_kernel, "trace_tiles")]


def recorded_bit_contract(calls, plain) -> list:
    """Each recorded sweep ``record_calls`` gave (the kernel's hits) held
    bit for bit to ``plain`` on the same arguments."""
    return [bit_contract(out, plain(*args, **dict(kw, impl="plain")))
            for args, kw, out in calls]


def same_surface_tables(a, b) -> None:
    """Two ``SurfaceClusterTable``s hold the same chunks with equal rows
    (slot order may differ: chunks drain in the order the workers finish)."""
    assert a._slots.keys() == b._slots.keys()
    assert (a.n_used, a.overflowed) == (b.n_used, b.overflowed)
    ta, tb = a.clusters(), b.clusters()
    for key, sa in a._slots.items():
        sb = b._slots[key]
        assert len(sa) == len(sb), key
        ia, ib = torch.tensor(sa, dtype=torch.long), torch.tensor(sb)
        for f in ("cbmin", "cbmax", "gmat"):
            assert torch.equal(getattr(ta, f).cpu()[ia],
                               getattr(tb, f)[ib]), (key, f)
        rows = lambda s: (s[:, None] * ta.kc + torch.arange(ta.kc)).reshape(-1)
        assert torch.equal(ta.tri_rows.cpu()[rows(ia)],
                           tb.tri_rows[rows(ib)]), key


def island_config():
    """The default island's ``WorldConfig`` (phases 17 and 18)."""
    from yetanotherconsolegameengine_tpu_torch.world.settings import (
        WorldConfig)
    return WorldConfig(chunks_x=8, chunks_y=4, chunks_z=8, view_distance=3)


def orbit_poses(vs, n):
    """The first ``n`` of the island orbit's ``ORBIT_POSES`` camera poses
    around the streamed scene ``vs``'s start."""
    eye = vs.pos.copy()
    eye[1] += 6.0
    return [(eye, math.pi * 2 * i / ORBIT_POSES, -0.35) for i in range(n)]


def island_dda_cases(calls) -> dict:
    """{f"island_dda_{P}": (world, o, d, tmin, tmax)}: the first recorded
    DDA sweep (``record_calls`` of ``dda.intersect_voxels``) of each ray
    count of a forced-DDA island frame."""
    cases = {}
    for args, _, _ in calls:
        cases.setdefault(f"island_dda_{args[1].shape[0]}", args[:5])
    return cases


def island_phases(dev, card):
    """Phases 17 and 18 on the default island (``island_config``),
    generated and saved once into a temporary directory. Returns (the
    orbit runs by size, the forced-DDA run with the DDA kernel's timed
    island sweeps under "dda_cases")."""
    from yetanotherconsolegameengine_tpu_torch.world import worldgen
    from yetanotherconsolegameengine_tpu_torch.world.manager import (
        WorldManager)
    from yetanotherconsolegameengine_tpu_torch.world.persistence import (
        WorldFile, save_world)
    from yetanotherconsolegameengine_tpu_torch.world.volume_scene import (
        build_minecraft_like)
    cfg = island_config()

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "island.vg")
        t0 = time.perf_counter()
        blocks, meta = worldgen.generate_world(cfg)
        gen_s = time.perf_counter() - t0
        save_world(path, blocks, meta)
        del blocks, meta
        t0 = time.perf_counter()
        vs = build_minecraft_like(cfg, world_path=path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        try:
            scene = vs.update(1.0 / 30.0)
            mgr = vs.manager
            cpu = WorldManager(cfg, mgr.lut, WorldFile(path),
                               transparent_banks=mgr._transparent,
                               surface_merge_lut=mgr._surf_merge,
                               device="cpu")
            try:
                cpu.ensure_all_loaded(vs.pos, timeout=300.0)
                cpu.surface_clusters()
                same_surface_tables(mgr._surface, cpu._surface)
                same_surface_tables(mgr._surface_lod, cpu._surface_lod)
            finally:
                cpu.shutdown()
            tables = {"window": list(mgr._cells.shape),
                      "full": [mgr._surface.n_used, mgr._surface.cap],
                      "lod": [mgr._surface_lod.n_used, mgr._surface_lod.cap],
                      "chunks": len(mgr._loaded)}
            poses = orbit_poses(vs, ORBIT_POSES)
            err, _ = renderer_contract(scene, FB_W, FB_H, dev, frames=1,
                                       cam=poses[0])
            print(f"phase 17a {card} default island: generation {gen_s:.2f} "
                  f"s, load and stream {load_s:.2f} s; tables "
                  f"{json.dumps(tables)}, equal to the CPU build; kernel vs "
                  f"plain renderer at {FB_W}x{FB_H}, 1 frame: "
                  f"{json.dumps(err)}", flush=True)
            orbit = {}
            for w, h in ((FB_W, FB_H), (DRAGON_W, DRAGON_H)):
                r = RaytraceRenderer(scene, w, h, device=dev)
                run = timed_frames(r, ORBIT_POSES,
                                   ("clusters", "cluster_cull", "post"),
                                   warmup=4, poses=poses)
                idle = idle_share(r, poses[:8])
                orbit[f"{w}x{h}"] = run
                print(f"phase 17b {card} island orbit {w}x{h} ss=1 "
                      f"render_many({ORBIT_POSES} poses): {run['ms']:.4f} "
                      f"ms/frame by CUDA events, {run['host_ms']:.4f} by host "
                      f"clock, {1000.0 / run['ms']:.2f} fps, {run['rays']} "
                      f"rays/frame (last frame), {run['mray_s']:.3f} Mray/s; "
                      f"launches {run['launches']}; over 8 poses: device busy "
                      f"{idle['busy_ms']:.4f} of {idle['wall_ms']:.4f} "
                      f"ms/frame, {idle['ops']:.1f} device operations/frame, "
                      f"idle share {idle['idle_share']:.4f}", flush=True)
        finally:
            vs.manager.shutdown()

        vs = build_minecraft_like(cfg, world_path=path, surface_mesh=False,
                                  device=dev)
        try:
            scene = vs.update(1.0 / 30.0)
            poses = orbit_poses(vs, DDA_ISLAND_FRAMES)
            err, r = renderer_contract(scene, FB_W, FB_H, dev, frames=1,
                                       cam=poses[0])
            calls = record_calls(r.render, dda, "intersect_voxels")
            assert calls, "no DDA sweep in a forced-DDA island frame"
            bits = recorded_bit_contract(calls, dda.intersect_voxels)
            # One sweep of each size timed as phase 15 times its cases.
            sweeps = sweep_kernel_cases(
                island_dda_cases(calls), "dda", dda.intersect_voxels,
                dda.march, lambda w: (w.cells, w.origin, w.voxel_size),
                dda.march_work, dda_bound)
            run = timed_frames(r, DDA_ISLAND_FRAMES, ("post", "dda"),
                               poses=poses)
            run["dda_cases"] = sweeps
            idle = idle_share(r, poses[:2])
        finally:
            vs.manager.shutdown()
    sw = max(1, run["dda"].get("sweeps", 0))
    print(f"phase 18 {card} forced-DDA island {FB_W}x{FB_H} ss=1 "
          f"({DDA_ISLAND_FRAMES} orbit poses, cut from bench_suite's 128 for "
          f"time): kernel vs plain renderer, 1 frame {json.dumps(err)}; "
          f"every DDA sweep of a frame ({len(calls)}) kernel vs the plain "
          f"loop bit for bit {json.dumps(bits)}; {run['ms']:.4f} ms/frame by "
          f"CUDA events, {run['host_ms']:.4f} by host clock, "
          f"{run['mray_s']:.3f} Mray/s; launches {run['launches']}; DDA per "
          f"frame {sw / DDA_ISLAND_FRAMES:.1f} sweeps, one launch each; the "
          f"first sweep of each size (ms: kernel device time | the sweep by "
          f"CUDA events; bound, share, work as in phase 15): "
          f"{json.dumps(run['dda_cases'])}; "
          f"device busy {idle['busy_ms']:.4f} of {idle['wall_ms']:.4f} "
          f"ms/frame, {idle['ops']:.1f} device operations/frame, idle share "
          f"{idle['idle_share']:.4f}", flush=True)
    return orbit, run


def same_dynamic_frame(card, cpu) -> dict:
    """Hold a dynamic scene's frame patched on the card to the same frame
    patched on the CPU: every table within 1e-6 (an LBVH's node boxes
    included) and every integer table, its leaf order included, equal."""
    a, b = card.to_numpy(), cpu.to_numpy()
    assert sorted(a) == sorted(b)
    err = 0.0
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if a[k].dtype.kind == "f" and a[k].size:
            e = float(np.abs(a[k] - b[k]).max())
            assert e <= 1e-6, f"{k} differs by {e}"
            err = max(err, e)
        else:
            assert np.array_equal(a[k], b[k]), f"{k} differs"
    return {"max_abs": err, "bvh_nodes": int(a["mesh.bmin"].shape[0])
            if "mesh.bmin" in a else 0}


def dynamic_phases(dev, card) -> dict:
    """Phase 20: ``exhibit_ring`` and ``spinning_mesh`` patched on the card
    equal to the CPU at several times, then rendered at 160x90 through
    ``render_many(times=, scene_fn=)``: kernel vs plain renderer and a
    timed run. Returns the timed runs by scene."""
    from yetanotherconsolegameengine_tpu_torch.scene.showcase_scenes import (
        build_exhibit_ring, build_spinning_mesh)
    runs = {}
    for name, build, frames in (("exhibit_ring", build_exhibit_ring,
                                 RING_FRAMES),
                                ("spinning_mesh", build_spinning_mesh,
                                 SPIN_FRAMES)):
        cpu = build()
        dyn = cpu.to(dev)
        assert dyn.device.type == "cuda"
        tables = {str(t): same_dynamic_frame(dyn.at_time(t), cpu.at_time(t))
                  for t in DYNAMIC_TIMES}
        patch_ms = cuda_ms(lambda: dyn.at_time(1.3), 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            dyn.at_time(1.3)
        torch.cuda.synchronize()
        patch_host = (time.perf_counter() - t0) * 1e3 / 10
        err, rk = renderer_contract(dyn.at_time(0.0), FB_W, FB_H, dev,
                                    frames=2, scene_fn=dyn.at_time)
        run = timed_frames(rk, frames, ("post", "bvh"), warmup=1,
                           scene_fn=dyn.at_time)
        assert run["launches"]["trace"] == 0, "a dynamic scene took K2"
        runs[name] = run
        print(f"phase 20 {card} {name}: at_time on the card vs the CPU at t "
              f"{list(DYNAMIC_TIMES)}: {json.dumps(tables)}; at_time "
              f"(table patches{', LBVH rebuild' if name == 'spinning_mesh' else ''}"
              f") {patch_ms:.4f} ms by CUDA events, {patch_host:.4f} by host "
              f"clock; {FB_W}x{FB_H} kernel vs plain renderer over 2 frames "
              f"of render_many(times=, scene_fn=): {json.dumps(err)}; "
              f"render_many({frames}): {run['ms']:.4f} ms/frame by CUDA "
              f"events, {run['host_ms']:.4f} by host clock, {run['rays']} "
              f"rays/frame (last frame), {run['mray_s']:.4f} Mray/s, "
              f"at_time {patch_ms / run['ms']:.2%} of a frame; launches "
              f"{run['launches']}; BVH walk {run['bvh']}", flush=True)
    return runs


_TICK_MS = re.compile(rb"fps \|\s*([0-9.]+) ms \|")


def run_program(argv):
    """Run the shell's ``main`` with fd 1 on a temporary file (its ANSI
    must not reach this script's stdout). Returns (exit code, what it
    wrote, wall seconds)."""
    from yetanotherconsolegameengine_tpu_torch.engine.program import main
    sys.stdout.flush()
    with tempfile.TemporaryFile() as f:
        saved = os.dup(1)
        os.dup2(f.fileno(), 1)
        t0 = time.perf_counter()
        try:
            rc = main(argv)
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
        wall = time.perf_counter() - t0
        f.seek(0)
        data = f.read()
    return rc, data, wall


def component_blits(scene: str, batch: int, w: int, h: int, ticks: int,
                    dev):
    """The framebuffer planes a ``RaytraceComponent`` blits on each of
    ``ticks`` ticks at 30 fps, with no input."""
    from yetanotherconsolegameengine_tpu_torch.engine.chexel import (
        Framebuffer)
    from yetanotherconsolegameengine_tpu_torch.engine.raytrace_entity import (
        RaytraceComponent)
    fb = Framebuffer(w, h)
    c = RaytraceComponent(fb, scene_names=[scene], enable_world=False,
                          batch=batch, device=dev)
    c.show_hud = False
    seq = []
    try:
        for _ in range(ticks):
            c.update(1.0 / 30.0)
            seq.append((fb.fg_ansi.copy(), fb.bg_ansi.copy(),
                        fb.fg_rgb.copy(), fb.bg_rgb.copy()))
    finally:
        c.close()
    return seq


def batched_contract(scene: str, batch: int, w: int, h: int, ticks: int,
                     dev) -> dict:
    """The batched component blits the unbatched one's frames (tick t
    shows frame t-1 on both): fg/bg grids bit-equal, RGB within 1/255.
    Launch counts cover both components."""
    kernels.reset_launches()
    one = component_blits(scene, 1, w, h, ticks, dev)
    many = component_blits(scene, batch, w, h, ticks, dev)
    launches = dict(kernels.LAUNCHES)
    rgb = 0.0
    for t in range(1, ticks):
        for i in (0, 1):
            assert np.array_equal(many[t][i], one[t][i]), (scene, t, i)
        rgb = max(rgb, *(float(np.abs(many[t][i] - one[t][i]).max())
                         for i in (2, 3)))
    assert rgb <= 1.0 / 255.0 + 1e-7, (scene, rgb)
    return {"scene": scene, "batch": batch, "size": f"{w}x{h}",
            "ticks": ticks, "rgb": rgb, "launches": launches}


def shell_phases(dev, card) -> dict:
    """Phase 21: the terminal program on the card, Cornell at 160x90 with
    --batch 1 and 8 (ms a tick from its HUD line, against render_many's
    ms/frame of the same frame), then the batched component against the
    unbatched one for Cornell and spinning_mesh."""
    from yetanotherconsolegameengine_tpu_torch import native
    argv = ["--scene", "cornell", "--frames", str(SHELL_TICKS), "--size",
            f"{FB_W}x{FB_H}", "--no-world", "--non-interactive"]
    shell = {}
    for batch in (1, 8):
        kernels.reset_launches()
        rc, data, wall = run_program(argv + ["--batch", str(batch)])
        launches = dict(kernels.LAUNCHES)
        assert rc == 0, f"program exited {rc}"
        assert b"\x1b[38;5;" in data and "\u2580".encode() in data \
            and b"fps" in data, "no ANSI frame or HUD in the output"
        assert launches["trace"] > 0 and launches["post"] > 0, launches
        ticks = [float(x) for x in _TICK_MS.findall(data)]
        assert len(ticks) == SHELL_TICKS, len(ticks)
        shell[batch] = {"tick_ms": float(np.mean(ticks[10:])),
                        "tick_ms_all": float(np.mean(ticks)),
                        "tick_ms_max": max(ticks), "wall_s": wall,
                        "bytes": len(data), "launches": launches}
    lib = native.load()
    assert lib is not None, "the native ANSI encoder did not load"
    r = RaytraceRenderer(SCENE_BUILDERS["cornell"](), FB_W, FB_H, device=dev)
    frame = timed_frames(r, SHELL_TICKS, ("trace", "post"), warmup=10)
    print(f"phase 21a {card} program cornell {FB_W}x{FB_H}, {SHELL_TICKS} "
          f"ticks: --batch 1 {shell[1]['tick_ms']:.4f} ms a tick (ticks "
          f"11-{SHELL_TICKS}; {shell[1]['tick_ms_all']:.4f} over all, max "
          f"{shell[1]['tick_ms_max']:.1f}), --batch 8 "
          f"{shell[8]['tick_ms']:.4f} ({shell[8]['tick_ms_all']:.4f} over "
          f"all, max {shell[8]['tick_ms_max']:.1f}); render_many("
          f"{SHELL_TICKS}) of the same frame {frame['ms']:.4f} ms/frame by "
          f"CUDA events, {frame['host_ms']:.4f} by host clock; runs "
          f"{json.dumps(shell)}; native encoder {lib._name}", flush=True)
    checks = [batched_contract("cornell", 4, FB_W, FB_H, 9, dev),
              batched_contract("spinning_mesh", 3, 48, 28, 4, dev)]
    assert checks[0]["launches"]["trace"] > 0
    assert checks[1]["launches"]["post"] > 0
    assert checks[1]["launches"]["bvh"] > 0
    assert checks[1]["launches"]["trace"] == 0
    print(f"phase 21b {card} batched component vs unbatched on the card: "
          f"{json.dumps(checks)}", flush=True)
    return {"shell": shell, "frame": frame, "checks": checks}


class _OneFrame:
    """A reader that always hands out one frame."""

    def __init__(self, frame):
        self.frame = frame

    def try_get_frame(self):
        return self.frame


def video_sync_phase(dev, card) -> None:
    """Phase 22: the video mode's frame on the card vs the CPU; the SCNE
    snapshot of a scene on the card equal to the CPU's; a replica read
    onto the card renders as the original."""
    from yetanotherconsolegameengine_tpu_torch.net.scene_sync import (
        read_snapshot, write_snapshot)
    from yetanotherconsolegameengine_tpu_torch.video.readers import (
        SyntheticReader)
    from yetanotherconsolegameengine_tpu_torch.video.renderer import (
        VideoRenderer)
    frame = SyntheticReader(width=320, height=180).try_get_frame()
    vr = VideoRenderer(_OneFrame(frame), FB_W, FB_H, device=dev)
    got = vr.render()
    want = VideoRenderer(_OneFrame(frame), FB_W, FB_H, device="cpu").render()
    rgb = max(float((got[k].cpu() - want[k]).abs().max()) for k in (0, 1))
    assert rgb <= 1e-5, f"video RGB differs by {rgb}"
    assert all(torch.equal(got[k].cpu(), want[k]) for k in (2, 3)), "ANSI"
    video_ms = cuda_ms(vr.render, 20)
    cornell = SCENE_BUILDERS["cornell"]()
    snap = write_snapshot(cornell.to(dev))
    assert snap == write_snapshot(cornell), "snapshot bytes differ"
    replica = read_snapshot(io.BytesIO(snap), device=dev)
    assert replica.device.type == "cuda"
    outs = [RaytraceRenderer(sc, 48, 28, device=dev).render_many(4)
            for sc in (cornell, replica)]
    assert torch.equal(outs[0][1].top_rgb, outs[1][1].top_rgb)
    assert all(torch.equal(a, b) for a, b in zip(outs[0][0], outs[1][0]))
    print(f"phase 22 {card} video mode {FB_W}x{FB_H} from a 320x180 frame: "
          f"card vs CPU RGB {rgb:.3g}, ANSI equal, {video_ms:.4f} ms a frame "
          f"by CUDA events; cornell snapshot from the card equals the CPU's "
          f"({len(snap)} bytes); the replica read onto the card renders "
          f"equal over 4 frames", flush=True)


def k1_global_phase(dev, card, inputs, cfg, shared: dict) -> dict:
    """Phase 6d: K1 under each configuration of ``K1_GLOBAL`` on the post
    ``inputs`` at 160x180, held to phase 4's contract against
    ``post_plain``, then timed as device time and by CUDA events beside
    the shared-memory configuration's ``shared`` times (phase 6c), with its
    least time. Returns each configuration's numbers."""
    h, w = inputs[0].shape[1:]
    res = {}
    for name, change in K1_GLOBAL.items():
        c = dataclasses.replace(cfg, **change)

        def k1():
            return post_kernel.post(*inputs, c, 2, True)
        got = k1()
        torch.cuda.synchronize()
        plain_ms, _, ref = timed(lambda: post_kernel.post_plain(
            *inputs, c, 2, True), 1, dev)
        err = post_contract([_np(x) for x in got], [_np(x) for x in ref])
        ms, ev = kernel_ms(k1, 100), cuda_ms(k1, 100)
        bound = roofline(w * h * k1_ops(c), K1_PLANES * w * h * 4)
        res[name] = {"ms": ms, "event_ms": ev, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "share": bound[0] / ms, "ops_per_pixel": k1_ops(c),
                     "max_abs_err": err["rgb"], "err": err}
    print(f"phase 6d {card} post kernel's global-memory phases at {w}x{h} "
          f"vs plain (phase 4's contract), ms per call (device time | CUDA "
          f"events), least time and share: {json.dumps(res)}; beside the "
          f"shared-memory configuration (6c) {shared['ms']:.4f} | "
          f"{shared['event_ms']:.4f}, bound {shared['bound_ms']:.5f}",
          flush=True)
    return res


def check_launched(counts: dict, keys, what: str) -> None:
    """Each kernel of ``keys`` launched at least once in ``counts``."""
    for k in keys:
        assert counts[k] > 0, f"{what}: kernel {k} was not launched"


def frame_diff(got: dict, want) -> dict:
    """A gathered sharded frame against the unsharded one: the largest
    top/bottom difference, the share of cells over 2e-5, fg ANSI flips and
    both ray counts."""
    off = np.maximum(np.abs(got["top_rgb"] - _np(want.top_rgb)).max(-1),
                     np.abs(got["bot_rgb"] - _np(want.bot_rgb)).max(-1))
    return {"rgb": float(off.max()), "cells_over": float((off > 2e-5).mean()),
            "fg_flips": float((got["fg_ansi"] != _np(want.fg_ansi)).mean()),
            "rays": [int(got["rays_traced"]), int(want.rays_traced)]}


def check_same_frame(d: dict, fg_equal: bool, what: str) -> None:
    """The JAX package's sharding contract (tests/test_pipeline.py:91-168)
    on ``frame_diff``'s numbers: top and bottom within 2e-5, fg ANSI equal
    (``fg_equal``) or under 0.5% flips, equal rays_traced."""
    assert d["rgb"] <= 2e-5, f"{what}: sharded top/bot differ by {d['rgb']}"
    assert d["fg_flips"] == 0.0 if fg_equal else d["fg_flips"] < 0.005, \
        f"{what}: fg flips {d['fg_flips']}"
    assert d["rays"][0] == d["rays"][1], f"{what}: rays {d['rays']}"


def unsharded(scene, w: int, h: int, dev, frames: int = SHARD_FRAMES,
              ss: int = 1):
    """The unsharded frame on the card (kernels) after ``frames`` frames."""
    r = RaytraceRenderer(scene, w, h, ss=ss, device=dev)
    out = None
    for _ in range(frames):
        out = r.render()
    return out


def band_post_err(inputs, bands, halo: int, cfg, fuse_tail: bool):
    """K1 band mode on ``bands`` of a frame's post ``inputs``: launch A on
    each extended band, the partials combined, launch B on each band,
    against ``post_band_plain`` and ``post_band_tail_plain`` on the same
    inputs, the bands' rows concatenated and held to phase 4's contract.
    Returns (the errors and the combined partial sums' difference, the
    kernels' combined partial)."""
    cur, prev, hist, valid, reset, ae = inputs
    h = cur.shape[1]
    outs = []
    for y0, y1 in bands:
        e0, e1 = max(0, y0 - halo), min(h, y1 + halo)
        ext = [x[:, e0:e1].contiguous() for x in (cur, prev, hist)]
        own = (y0 - e0, y1 - e0)
        outs.append((post_kernel.post_band(*ext, valid, reset, cfg, 2, e0,
                                           own),
                     post_kernel.post_band_plain(*ext, valid, reset, cfg, 2,
                                                 e0, own)))
    total = post_kernel.combine_partials(torch.stack([k[2] for k, _ in outs]))
    want_total = post_kernel.combine_partials(torch.stack(
        [p[2] for _, p in outs]))
    assert float(total[1]) == float(want_total[1]), "sample counts"
    tails = [(post_kernel.post_band_tail(k[1], total, ae, cfg, fuse_tail),
              post_kernel.post_band_tail_plain(p[1], want_total, ae, cfg,
                                               fuse_tail))
             for k, p in outs]
    torch.cuda.synchronize()

    def cat(xs):
        return None if xs[0] is None else np.concatenate(
            [_np(x) for x in xs], axis=-2)
    err = post_contract(
        [cat([k[0] for k, _ in outs]), cat([t[0] for t, _ in tails]),
         cat([t[1] for t, _ in tails]), _np(tails[0][0][2])],
        [cat([p[0] for _, p in outs]), cat([t[0] for _, t in tails]),
         cat([t[1] for _, t in tails]), _np(tails[0][1][2])])
    err["partial_sum"] = abs(float(total[0]) - float(want_total[0]))
    return err, total


def sharding_phases(dev, card, packs, post_in, dragon, cfg) -> dict:
    """Phase 23: row bands of the frame over ranks that share the card
    (gloo, host-staged exchange). Returns what the kernels line reports:
    the band launches' times and launches by sharded path."""
    import functools

    from yetanotherconsolegameengine_tpu_torch.parallel import sharding
    from yetanotherconsolegameengine_tpu_torch.scene.voxel_scenes import (
        build_voxel_test_scene)
    how = "ranks sharing the one card over gloo, exchange staged through " \
          "pinned host memory"

    # (a) band kernels against the full frame and their plain versions, on
    # the bands of the traced shapes the sharded frames below run (Cornell
    # 160x180 on 2 ranks, cornell88's 160x176 on 2 and 4, the dragon's
    # 240x272 on 2) and on Cornell 160x180's 4 bands.
    packed = packs["cornell"]
    halo = post_kernel.halo_rows(cfg)
    band_shapes = ((HI_W, HI_H, (2, 4)), (FB_W, SHARD_FB_H * 2, (2, 4)),
                   (DRAGON_W, SHARD_DRAGON_H * 2, (2,)))
    band_err, k2_bands, totals = {}, {}, {}
    for w, h, worlds in band_shapes:
        params, frames = trace_inputs(packed.scene, w, h, TRACE_FRAME, dev)
        full = trace_kernel.trace_planes(packed, params, frames, 0, w, h, cfg)
        if (w, h) not in post_in:
            post_in[w, h] = post_inputs(packed, w, h, dev, cfg)
        for n in worlds:
            bands = [(r * h // n, (r + 1) * h // n) for r in range(n)]
            for rows in bands:
                got = trace_kernel.trace_planes(packed, params, frames, 0, w,
                                                h, cfg, rows)
                torch.cuda.synchronize()
                assert torch.equal(got, full[:, rows[0]:rows[1]]), \
                    f"K2 band {rows} of {w}x{h}"
            k2_bands[f"{w}x{h}"] = k2_bands.get(f"{w}x{h}", []) + bands
            for fuse_tail in (True, False):
                band_err[f"{w}x{h} {n} bands fuse_tail={fuse_tail}"], \
                    totals[w, h, n] = band_post_err(post_in[w, h], bands,
                                                    halo, cfg, fuse_tail)
    cur, prev, hist, valid, reset, ae = post_in[HI_W, HI_H]
    params, frames = trace_inputs(packed.scene, HI_W, HI_H, TRACE_FRAME, dev)
    bands = [(r * HI_H // 4, (r + 1) * HI_H // 4) for r in range(4)]
    total = totals[HI_W, HI_H, 4]
    # Each launch's device time on the middle band of 4 (45 owned rows, 75
    # rows with the halo), beside the whole frame's one launch (phase 6c).
    y0, y1 = bands[1]
    e0, e1 = y0 - halo, y1 + halo
    ext = [x[:, e0:e1].contiguous() for x in (cur, prev, hist)]
    a_out = post_kernel.post_band(*ext, valid, reset, cfg, 2, e0,
                                  (y0 - e0, y1 - e0))
    ms_a = kernel_ms(lambda: post_kernel.post_band(
        *ext, valid, reset, cfg, 2, e0, (y0 - e0, y1 - e0)), 100)
    ms_b = kernel_ms(lambda: post_kernel.post_band_tail(
        a_out[1], total, ae, cfg, True), 100)
    k2_band = trace_kernel.trace_planes(packed, params, frames, 0, HI_W,
                                        HI_H, cfg, (y0, y1))
    k2_band_ms = kernel_ms(lambda: trace_kernel.trace_planes(
        packed, params, frames, 0, HI_W, HI_H, cfg, (y0, y1)), 100)
    # Least times as in phase 6c. Launch A does the TAA and every a-trous
    # pass but the last over the extended band, and the last pass and the
    # exposure sample over the owned rows; it reads K1's input planes of
    # the extended band and writes blended and denoised RGB of the owned
    # rows. Launch B runs the tail on the owned rows: it reads 3 planes and
    # writes 3 and the ANSI plane.
    n_prims = sum(int(getattr(packed.scene, name).mask.sum())
                  for name, _ in INTERSECTORS)
    ext_px, own_px = (e1 - e0) * HI_W, (y1 - y0) * HI_W
    timing = {"k1_band_a_ms": ms_a, "k1_band_b_ms": ms_b,
              "k2_band_ms": k2_band_ms, "band_rows": y1 - y0,
              "extended_rows": e1 - e0,
              "k1_band_a_bound_ms": roofline(
                  ext_px * (K1_TAA_OPS + (cfg.atrous_iterations - 1)
                            * K1_PASS_OPS)
                  + own_px * (K1_PASS_OPS + K1_LOG_OPS),
                  (K1_PLANES - 7) * ext_px * 4 + 6 * own_px * 4)[0],
              "k1_band_b_bound_ms": roofline(own_px * K1_TAIL_OPS,
                                             7 * own_px * 4)[0],
              "k2_band_bound_ms": roofline(
                  int(k2_band[11].sum()) * n_prims * K2_OPS,
                  packed.table.numel() * 4 + k2_band.numel() * 4)[0]}
    print(f"phase 23a {card} band kernels: K2 on the bands "
          f"{json.dumps(k2_bands)} bit-equal to the full frame's rows; K1 "
          f"band mode (launch A + B over each shape's bands, halo {halo}) vs "
          f"its plain version: {json.dumps(band_err)}; device time on a "
          f"{y1 - y0}-row band of {HI_W}x{HI_H} "
          f"band ({e1 - e0} rows with the halo): {json.dumps(timing)}",
          flush=True)

    # (b) the dryrun.
    t0 = time.perf_counter()
    dry = sharding.dryrun(4, device="cuda", backend="gloo")
    dry_launches = {name: [list(r["launches"][name].values()) for r in dry]
                    for name in dry[0]["launches"]}
    print(f"phase 23b {card} dryrun(4), {how}: scenes "
          f"{sorted(dry[0]['frames'])} "
          f"finite at 32x8 cells on every rank; launches (trace, post, "
          f"clusters, bvh, dda) of each rank {json.dumps(dry_launches)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (c) the sharded frames against the unsharded frame.
    cornell = SCENE_BUILDERS["cornell"]
    timed = sharding.FrameJob("cornell88", cornell, FB_W, SHARD_FB_H,
                              SHARD_FRAMES, timed=SHARD_TIMED)
    jobs2 = [sharding.FrameJob("cornell", cornell, FB_W, FB_H, SHARD_FRAMES),
             sharding.FrameJob("cornell_ss2", cornell, FB_W, FB_H,
                               SHARD_FRAMES, ss=2),
             timed,
             sharding.FrameJob("dragon", SCENE_BUILDERS["dragon"], DRAGON_W,
                               SHARD_DRAGON_H, SHARD_FRAMES,
                               timed=SHARD_DRAGON_TIMED)]
    small = {"cluster_forced": FORCED_SCENE_BUILDERS["cluster_forced"],
             "voxel_test": SCENE_BUILDERS["voxel_test"],
             "voxel_test_dda": functools.partial(build_voxel_test_scene,
                                                 merge="dda"),
             "teapot": SCENE_BUILDERS["teapot"]}
    jobs4 = [timed] + [sharding.FrameJob(k, b, 48, 28, SHARD_FRAMES)
                       for k, b in small.items()]
    t0 = time.perf_counter()
    res2 = sharding.spawn(2, sharding.frames_job, jobs2, device="cuda",
                          backend="gloo")
    s2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    res4 = sharding.spawn(4, sharding.frames_job, jobs4, device="cuda",
                          backend="gloo")
    s4 = time.perf_counter() - t0
    want = {"cornell": unsharded(cornell(), FB_W, FB_H, dev),
            "cornell_ss2": unsharded(cornell(), FB_W, FB_H, dev, ss=2),
            "cornell88": unsharded(cornell(), FB_W, SHARD_FB_H, dev),
            "dragon": unsharded(dragon, DRAGON_W, SHARD_DRAGON_H, dev),
            **{k: unsharded(b(), 48, 28, dev) for k, b in small.items()}}
    need = {"cornell": ("trace", "post"), "cornell_ss2": ("trace", "post"),
            "cornell88": ("trace", "post"),
            "dragon": ("clusters", "cluster_cull", "post"),
            "cluster_forced": ("clusters", "cluster_cull", "post"),
            "voxel_test": ("trace", "post"),
            "voxel_test_dda": ("post", "dda"), "teapot": ("post", "bvh")}
    contract, launches = {}, {}
    for n, res in ((2, res2), (4, res4)):
        for name in res[0]["frames"]:
            contract[f"{name} {n} ranks"] = frame_diff(
                res[0]["frames"][name], want[name])
            launches[f"sharded_{name}_{n}ranks"] = [r["launches"][name]
                                                    for r in res]
    print(f"phase 23c {card} sharded frames vs the unsharded frame on the "
          f"card ({how}; Cornell {FB_W}x{FB_H} ss=1 and ss=2 on 2 ranks and "
          f"{FB_W}x"
          f"{SHARD_FB_H} (cornell88) on 2 and 4, dragon {DRAGON_W}x"
          f"{SHARD_DRAGON_H}, the rest 48x28; {SHARD_FRAMES} frames; spawns of 2 "
          f"and 4 ranks {s2:.1f} s and {s4:.1f} s): {json.dumps(contract)}; "
          f"launches (trace, post, clusters, bvh, dda) of each rank "
          f"{json.dumps({k: [list(c.values()) for c in v] for k, v in launches.items()})}",
          flush=True)
    for (what, d), (key, per_rank) in zip(contract.items(), launches.items()):
        name = what.split()[0]
        check_same_frame(d, name.startswith("cornell"), what)
        for r, counts in enumerate(per_rank):
            check_launched(counts, need[name], f"{key} rank {r}")

    # (d) ms/frame at 1, 2 and 4 ranks.
    with tempfile.TemporaryDirectory() as tmp:
        group = sharding.make_group(0, 1, torch.distributed.FileStore(
            os.path.join(tmp, "store"), 1), "gloo", "cuda")
        try:
            res1 = sharding.frames_job(group, [timed])
        finally:
            torch.distributed.destroy_process_group()
    per_rank = {1: [res1["ms"]["cornell88"]],
                2: [r["ms"]["cornell88"] for r in res2],
                4: [r["ms"]["cornell88"] for r in res4]}
    dragon_ms = [r["ms"]["dragon"] for r in res2]
    print(f"phase 23d {card} Cornell {FB_W}x{SHARD_FB_H} ss=1 ms/frame by each "
          f"rank's CUDA events over {SHARD_TIMED} sharded frames, {how} (the "
          f"cost of the exchange and the split post where ranks share a "
          f"card; not a scale-out figure): "
          f"{json.dumps({f'{n} ranks': max(v) for n, v in per_rank.items()})}"
          f" (per rank {json.dumps(per_rank)}); dragon {DRAGON_W}x"
          f"{SHARD_DRAGON_H} "
          f"on 2 ranks over {SHARD_DRAGON_TIMED} frames: {max(dragon_ms):.3f} "
          f"ms/frame", flush=True)
    return {"timing": timing, "launches": launches,
            "ms": {n: max(v) for n, v in per_rank.items()},
            "dragon_ms": max(dragon_ms),
            "jobs": {j.name: j for j in jobs2 + jobs4}, "want": want,
            "need": need}


def scene_tensors(v, path: str = "") -> dict:
    """{field path: tensor} of every tensor in a scene, in field order."""
    if isinstance(v, torch.Tensor):
        return {path: v}
    out = {}
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        for f in dataclasses.fields(v):
            out.update(scene_tensors(getattr(v, f.name),
                                     f"{path}.{f.name}".lstrip(".")))
    return out


def every_dtype_scene(island, dev):
    """The island's scene (its surface cluster tables) carrying also the
    texture bank of ``texture_test``, the teapot's LBVH rows and soup and
    the voxel grid of ``voxel_test``'s DDA form, on ``dev``: every tensor
    dtype a shipped scene holds, in one scene."""
    from yetanotherconsolegameengine_tpu_torch.scene.voxel_scenes import (
        build_voxel_test_scene)
    tex = SCENE_BUILDERS["texture_test"]().to(dev)
    teapot = SCENE_BUILDERS["teapot"]().to(dev)
    vox = build_voxel_test_scene(merge="dda").to(dev)
    return dataclasses.replace(island.to(dev), textures=tex.textures,
                               mesh=teapot.mesh, mesh_soup=teapot.mesh_soup,
                               voxels=vox.voxels)


def scene_round_trip(group, scene) -> dict:
    """``broadcast_scene`` of ``scene`` from rank 0 of ``group``: every
    tensor back on the group's device, equal, of the same dtype and shape.
    Returns the tensors, bytes and dtypes sent."""
    from yetanotherconsolegameengine_tpu_torch.parallel import sharding
    got = sharding.broadcast_scene(group, scene)
    sent, back = scene_tensors(scene), scene_tensors(got)
    assert list(sent) == list(back), "scene layout changed in the broadcast"
    for path, t in sent.items():
        g = back[path]
        assert g.dtype == t.dtype and g.shape == t.shape, path
        assert g.device == group.device, f"{path} on {g.device}"
        assert torch.equal(g, t), f"{path} differs after the broadcast"
    return {"tensors": len(sent),
            "bytes": sum(t.numel() * t.element_size() for t in sent.values()),
            "dtypes": sorted({str(t.dtype).replace("torch.", "")
                              for t in sent.values()})}


def combine_check(group, inputs, cfg) -> dict:
    """``RowGroup.combine`` at world 1 on K1's band launch A over the
    whole frame of post ``inputs``: the combined partial is the band's
    partial bit for bit, the rays its own, and the exposure launch B
    derives from it holds phase 4's contract against the unsharded
    K1's."""
    cur, prev, hist, valid, reset, ae = inputs
    h = cur.shape[1]
    _, denoised, part = post_kernel.post_band(cur, prev, hist, valid, reset,
                                              cfg, 2, 0, (0, h))
    rays = cur[11].to(torch.int64).sum()
    total, got_rays = group.combine(part, rays)
    want_total = post_kernel.combine_partials(part[None])
    _, _, band_ae = post_kernel.post_band_tail(denoised, total, ae, cfg, True)
    *_, full_ae = post_kernel.post(*inputs, cfg, 2, True)
    assert torch.equal(total, want_total), \
        f"combined partial {total.tolist()} != {want_total.tolist()}"
    assert int(got_rays) == int(rays), "combined rays"
    err = abs(float(band_ae) - float(full_ae))
    assert err <= 1e-5, f"exposure {float(band_ae)} vs {float(full_ae)}"
    return {"partial": total.tolist(), "exposure": float(band_ae),
            "unsharded_exposure": float(full_ae), "exposure_err": err}


def world1_run(backend, jobs, cfg, extra=None) -> dict:
    """``frames_job`` of ``jobs`` on a world-1 group over a FileStore in a
    temporary directory, then ``extra(group)`` when given: ``backend``
    None joins through ``make_group``'s default. The group is destroyed
    on the way out."""
    from yetanotherconsolegameengine_tpu_torch.parallel import sharding
    with tempfile.TemporaryDirectory() as tmp:
        store = torch.distributed.FileStore(os.path.join(tmp, "store"), 1)
        group = (sharding.make_group(0, 1, store, device="cuda")
                 if backend is None else
                 sharding.make_group(0, 1, store, backend, "cuda"))
        try:
            res = sharding.frames_job(group, jobs, cfg)
            res["group"] = {"backend": group.backend,
                            "exchange": str(group.exchange_device),
                            "staged": group.staged}
            if extra is not None:
                res["extra"] = extra(group)
        finally:
            torch.distributed.destroy_process_group()
    return res


def nccl_phase(dev, card, shard, dragon, island, inputs, cfg) -> dict:
    """Phase 23e: phase 23c's sharded frames at world 1 over the group
    ``make_group`` makes by default on CUDA (NCCL, the exchange on the
    card): each frame bit-equal to the same frames over a world-1 gloo
    group and held to 23c's contract against the unsharded frame, the
    kernels launched as 23c counts them; a scene of every dtype through
    ``broadcast_scene``; ``combine`` against the unsharded exposure;
    Cornell 160x88 ms/frame over NCCL and gloo, in turns (gloo, NCCL,
    NCCL, gloo), beside the unsharded ``render()`` of one frame a call.
    No fallback: an NCCL failure raises. Returns the runs' launches by
    path and the times."""
    t0 = time.perf_counter()
    jobs, want = [], dict(shard["want"])
    for name, job in shard["jobs"].items():
        if name == "dragon":
            job = dataclasses.replace(job, build=lambda: dragon, timed=0)
        jobs.append(job)
    timed_job = [shard["jobs"]["cornell88"]]
    r = RaytraceRenderer(SCENE_BUILDERS["cornell"](), FB_W, SHARD_FB_H,
                         device=dev)
    one_ms = cuda_ms(r.render, SHARD_TIMED)
    gloo = world1_run("gloo", jobs, cfg)
    nccl = world1_run(None, jobs, cfg, lambda g: {
        "round_trip": scene_round_trip(g, every_dtype_scene(island, dev)),
        "combine": combine_check(g, inputs, cfg)})
    nccl2 = world1_run(None, timed_job, cfg)
    gloo2 = world1_run("gloo", timed_job, cfg)
    took = time.perf_counter() - t0
    assert nccl["group"] == {"backend": "nccl", "exchange": str(dev),
                             "staged": False}, nccl["group"]
    assert gloo["group"]["backend"] == "gloo" and gloo["group"]["staged"]
    contract, launches = {}, {}
    for name, frame in nccl["frames"].items():
        for k, a in frame.items():
            assert np.array_equal(a, gloo["frames"][name][k]), \
                f"{name} {k}: NCCL frame differs from the gloo frame"
        contract[name] = frame_diff(frame, want[name])
        check_same_frame(contract[name], name.startswith("cornell"),
                         f"{name} 1 rank nccl")
        check_launched(nccl["launches"][name], shard["need"][name],
                       f"{name} 1 rank nccl")
        launches[f"sharded_{name}_1rank_nccl"] = [nccl["launches"][name]]
    ms = {"nccl": [nccl["ms"]["cornell88"], nccl2["ms"]["cornell88"]],
          "gloo": [gloo["ms"]["cornell88"], gloo2["ms"]["cornell88"]]}
    print(f"phase 23e {card} world 1 over make_group's default on CUDA: "
          f"{json.dumps(nccl['group'])} (gloo: {json.dumps(gloo['group'])});"
          f" phase 23c's scenes, each NCCL frame bit-equal to the gloo "
          f"frame; vs the unsharded frame {json.dumps(contract)}; launches "
          f"(trace, post, clusters, bvh, dda) "
          f"{json.dumps({k: list(nccl['launches'][k].values()) for k in nccl['launches']})}"
          f"; broadcast_scene round trip exact "
          f"{json.dumps(nccl['extra']['round_trip'])}; combine "
          f"{json.dumps(nccl['extra']['combine'])}; Cornell {FB_W}x"
          f"{SHARD_FB_H} ss=1 ms/frame by CUDA events over {SHARD_TIMED} "
          f"frames, in turns gloo, nccl, nccl, gloo: {json.dumps(ms)}, "
          f"unsharded render() a frame {one_ms:.4f}; frames "
          f"{json.dumps({j.name: j.n_frames for j in jobs})}; {took:.1f} s",
          flush=True)
    return {"launches": launches, "ms": ms, "unsharded_render_ms": one_ms}


def many_lights_scene(SceneBuilder, Material):
    """Cornell's room with a mirror sphere, lit by ``N_LIGHTS`` colored
    point lights in a ring under the ceiling, built with the given
    package's ``SceneBuilder`` and ``Material``. The JAX package sends a
    scene of more than 8 lights to its wavefront
    (``ops/pallas_trace.py:80``); the port's trace kernel loops over every
    light of the table."""
    s = SceneBuilder("many_lights")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.02
    white = Material.solid((0.82, 0.82, 0.82))
    s.add_yz_rect(0.0, 5.0, -5.0, 0.0, -3.0, Material.solid((0.8, 0.1, 0.1)))
    s.add_yz_rect(0.0, 5.0, -5.0, 0.0, 3.0, Material.solid((0.1, 0.8, 0.1)))
    s.add_xz_rect(-3.0, 3.0, -5.0, 0.0, 0.0, white)
    s.add_xz_rect(-3.0, 3.0, -5.0, 0.0, 5.0, white)
    s.add_xy_rect(-3.0, 3.0, 0.0, 5.0, -5.0, white)
    s.add_box((-2.2, 0.0, -4.0), (-0.8, 1.0, -2.8), white)
    s.add_sphere((1.2, 0.9, -2.9), 0.9,
                 Material.solid((0.95, 0.95, 0.95), reflectivity=0.7))
    for i in range(N_LIGHTS):
        a = 2.0 * math.pi * i / N_LIGHTS
        s.add_light((1.8 * math.cos(a), 4.3, -2.6 + 1.5 * math.sin(a)),
                    (0.6 + 0.4 * math.cos(a), 0.8, 0.6 + 0.4 * math.sin(a)),
                    3.0)
    s.bg_top = s.bg_bottom = (0.0, 0.0, 0.0)
    s.set_camera((0.0, 1.0, 3.0), fov=60.0)
    return s.build()


def row_kernels_contract(scene, w: int, h: int, ss: int, dev, cfg) -> dict:
    """K2 and K1 against their plain versions on a suite row's own scene
    and traced size (w * ss by h * 2 * ss pixels), with the post options
    the renderer gives that ss (sample step max(2, 2 ss), tail fused at
    ss=1): the trace contract and the post contract."""
    hw, hh = w * ss, h * 2 * ss
    packed = trace_kernel.pack_scene(scene.to(dev))
    params, frames = trace_inputs(packed.scene, hw, hh, TRACE_FRAME, dev)
    got = trace_kernel.trace_planes(packed, params, frames, 0, hw, hh, cfg)
    torch.cuda.synchronize()
    trace = trace_contract(_np(got), _np(trace_kernel.trace_planes_plain(
        packed.scene, params[0], TRACE_FRAME, hw, hh, cfg)))
    inputs = post_inputs(packed, hw, hh, dev, cfg)
    opts = (cfg, max(2, 2 * ss), ss == 1)
    got = post_kernel.post(*inputs, *opts)
    torch.cuda.synchronize()
    post = post_contract([_np(x) for x in got],
                         [_np(x) for x in post_kernel.post_plain(*inputs,
                                                                 *opts)])
    return {"size": f"{hw}x{hh}", "trace": trace, "post": post}


def captured_row(fn):
    """Run a ``bench_suite`` row function; returns (the one line it
    printed, parsed; the launch counts of the row's timed loops)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0]), dict(kernels.LAUNCHES)


def suite_phase(dev, card, cfg) -> dict:
    """Phase 24: the two open checks (the mirror_spheres ss=2 frame and a
    10-light frame through K2, each against its plain version), the
    suite's rows 1-5 (each row's K2 and K1 first held against plain on
    its scene at its own size) and 14, and ``python -m
    yetanotherconsolegameengine_tpu_torch.bench``. Returns the rows'
    launch counts by row for the kernels line."""
    t0 = time.perf_counter()
    mirror = SCENE_BUILDERS["mirror_spheres"]()
    ss2_err, _ = renderer_contract(mirror, DRAGON_W, DRAGON_H, dev, ss=2)
    from yetanotherconsolegameengine_tpu_torch.scene.materials import (
        Material)
    from yetanotherconsolegameengine_tpu_torch.scene.tables import (
        SceneBuilder)
    lit = many_lights_scene(SceneBuilder, Material)
    assert int(lit.lights.mask.sum()) == N_LIGHTS
    assert trace_kernel.scene_fits(lit, cfg), "10 lights do not fit K2"
    packed = trace_kernel.pack_scene(lit.to(dev))
    params, frames = trace_inputs(packed.scene, HI_W, HI_H, TRACE_FRAME,
                                  dev)
    before = kernels.LAUNCHES["trace"]
    got = trace_kernel.trace_planes(packed, params, frames, 0, HI_W, HI_H,
                                    cfg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["trace"] == before + 1
    lit_err = trace_contract(_np(got), _np(trace_kernel.trace_planes_plain(
        packed.scene, params[0], TRACE_FRAME, HI_W, HI_H, cfg)))
    lit_frame, _ = renderer_contract(lit, FB_W, FB_H, dev)
    print(f"phase 24a {card} open checks: mirror_spheres {DRAGON_W}x"
          f"{DRAGON_H} ss=2, kernel vs plain renderer over 4 frames "
          f"{json.dumps(ss2_err)}; {N_LIGHTS}-light room through the trace "
          f"kernel vs plain at {HI_W}x{HI_H} {json.dumps(lit_err)}, kernel "
          f"vs plain renderer at {FB_W}x{FB_H} {json.dumps(lit_frame)}",
          flush=True)

    from yetanotherconsolegameengine_tpu_torch import bench_suite
    by_row = {}
    for name, label, build, w, h, kw in bench_suite.STATIC_ROWS[:5]:
        scene = build()
        fits = trace_kernel.scene_fits(scene, cfg)
        assert fits or name not in ("cornell", "voxel_test"), name
        if fits:
            err = row_kernels_contract(scene, w, h, kw.get("ss", 1), dev, cfg)
            print(f"phase 24b {card} {name}: trace and post kernels vs plain "
                  f"at the row's own size {json.dumps(err)}", flush=True)
        row, launches = captured_row(lambda: bench_suite.bench_scene(
            label, scene, w, h, device=dev, **dict(kw, batch=SUITE_BATCH)))
        print(f"phase 24b {card} {json.dumps(row)}", flush=True)
        for k in ("fps", "mrays_per_s", "interactive_fps",
                  "batched_interactive_fps_k8", "ms_per_frame",
                  "host_ms_per_frame"):
            assert math.isfinite(row[k]) and row[k] > 0, (k, row)
        want = ["post", "trace"] if fits else ["post", "prim"]
        assert row["kernels"] == want, (row, want)
        by_row[label] = launches
    row, _ = captured_row(lambda: bench_suite.bench_lbvh_rebuild(device=dev))
    print(f"phase 24b {card} {json.dumps(row)}", flush=True)
    assert math.isfinite(row["ms"]) and row["ms"] > 0, row

    proc = subprocess.run(
        [sys.executable, "-m", "yetanotherconsolegameengine_tpu_torch.bench"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["unit"] == "Mray/s" and math.isfinite(line["value"]) \
        and line["value"] > 0, line
    print(f"phase 24c {card} python -m "
          f"yetanotherconsolegameengine_tpu_torch.bench: {json.dumps(line)}; "
          f"phase 24 took {time.perf_counter() - t0:.1f} s", flush=True)
    return by_row


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script runs only on a CUDA card")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DEFAULT_CONFIG

    # ---- 1. environment ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    try:
        nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                              capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[-1]
    except (RuntimeError, OSError, subprocess.CalledProcessError) as e:
        nvcc = f"unavailable ({e})"
    try:
        import triton  # noqa: F401
        has_triton = f"yes {triton.__version__}"
    except ImportError:
        has_triton = "no"
    card = f"[{smi}]"
    print(f"phase 1 env: {card} torch {torch.__version__} cuda "
          f"{torch.version.cuda} capability "
          f"{torch.cuda.get_device_capability(0)} nvcc '{nvcc}' triton "
          f"{has_triton}", flush=True)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernels.library()
    print(f"phase 2 build: {len(kernels.sources())} sources -> "
          f"{kernels.BUILD_DIR} in {time.perf_counter() - t0:.2f} s "
          f"(flags {' '.join(kernels.NVCC_FLAGS)})", flush=True)

    # ---- 3. trace kernel vs plain ----------------------------------------
    trace_err = {}
    packs = {}
    for name in TRACE_SCENES:
        packed = trace_kernel.pack_scene(SCENE_BUILDERS[name]().to(dev))
        packs[name] = packed
        params, frames = trace_inputs(packed.scene, HI_W, HI_H, TRACE_FRAME,
                                      dev)
        got = trace_kernel.trace_planes(packed, params, frames, 0, HI_W,
                                        HI_H, cfg)
        torch.cuda.synchronize()
        ref = trace_kernel.trace_planes_plain(packed.scene, params[0],
                                              TRACE_FRAME, HI_W, HI_H, cfg)
        trace_err[name] = trace_contract(_np(got), _np(ref))
    print(f"phase 3 trace kernel vs plain at {HI_W}x{HI_H}: "
          f"{json.dumps(trace_err)}", flush=True)

    # ---- 4. post kernel vs plain -----------------------------------------
    post_err, post_in = {}, {}
    for w, h in ((HI_W, HI_H), (DRAGON_W, DRAGON_H * 2)):
        post_in[w, h] = inputs = post_inputs(packs["cornell"], w, h, dev, cfg)
        for fuse_tail in (True, False):
            got = post_kernel.post(*inputs, cfg, 2, fuse_tail)
            torch.cuda.synchronize()
            ref = post_kernel.post_plain(*inputs, cfg, 2, fuse_tail)
            post_err[f"{w}x{h} fuse_tail={fuse_tail}"] = post_contract(
                [_np(x) for x in got], [_np(x) for x in ref])
    inputs = post_in[HI_W, HI_H]
    print(f"phase 4 post kernel vs plain: {json.dumps(post_err)}",
          flush=True)

    # ---- 5. goldens on the card ------------------------------------------
    goldens = np.load(os.path.join(ROOT, "tests", "goldens.npz"))
    golden_err = {}
    for name in TRACE_SCENES:
        r = RaytraceRenderer(SCENE_BUILDERS[name](), 48, 28, device=dev)
        for _ in range(4):
            out = r.render()
        e = max(np.abs(_np(out.top_rgb) - goldens[f"{name}_top"]).max(),
                np.abs(_np(out.bot_rgb) - goldens[f"{name}_bot"]).max())
        assert e <= 2e-3, f"{name}: golden error {e}"
        golden_err[name] = float(e)
    print(f"phase 5 goldens on the card (48x28, 4 frames, kernels): "
          f"{json.dumps(golden_err)}", flush=True)

    # ---- 6. the slice at full size ---------------------------------------
    c_err, rk = renderer_contract(SCENE_BUILDERS["cornell"](), FB_W, FB_H,
                                  dev)
    print(f"phase 6a {card} kernel vs plain renderer at {FB_W}x{FB_H}, 4 "
          f"frames: {json.dumps(c_err)}", flush=True)
    c_run = timed_frames(rk, TIMED_FRAMES, ("trace", "post"), warmup=20)
    launches = c_run["launches"]
    print(f"phase 6b {card} Cornell {FB_W}x{FB_H} ss=1 render_many("
          f"{TIMED_FRAMES}): {c_run['ms']:.4f} ms/frame (device events), "
          f"{1000.0 / c_run['ms']:.1f} fps, {c_run['rays']} rays/frame (last "
          f"frame), {c_run['mray_s']:.2f} Mray/s; host clock "
          f"{c_run['host_ms']:.4f} ms/frame; launches {launches}", flush=True)

    # Per-kernel times at the main path's shapes, kernel beside plain.
    packed = rk.packed
    params, frames = trace_inputs(packed.scene, HI_W, HI_H, TRACE_FRAME, dev)

    def k2():
        return trace_kernel.trace_planes(packed, params, frames, 0, HI_W,
                                         HI_H, cfg)

    def k1(w=HI_W, h=HI_H):
        return post_kernel.post(*post_in[w, h], cfg, 2, True)

    t_k2 = cuda_ms(k2, 100)
    d_k2 = kernel_ms(k2, 100)
    t_k2p = cuda_ms(lambda: trace_kernel.trace_planes_plain(
        packed.scene, params[0], TRACE_FRAME, HI_W, HI_H, cfg), 5, 1)
    t_k1 = cuda_ms(k1, 100)
    d_k1 = kernel_ms(k1, 100)
    t_k1p = cuda_ms(lambda: post_kernel.post_plain(*inputs, cfg, 2, True),
                    10, 2)
    dw, dh = DRAGON_W, DRAGON_H * 2
    t_k1d = cuda_ms(lambda: k1(dw, dh), 100)
    d_k1d = kernel_ms(lambda: k1(dw, dh), 100)
    # Least times: K2 counts only its ray-primitive tests (this frame's
    # rays_traced x valid primitive rows), K1 its per-pixel stencil work;
    # bytes are the inputs read once and the outputs written once.
    k2_out = trace_kernel.trace_planes(packed, params, frames, 0, HI_W, HI_H,
                                       cfg)
    n_prims = sum(int(getattr(packed.scene, name).mask.sum())
                  for name, _ in INTERSECTORS)
    k2_rays = int(k2_out[11].sum())
    k2_bound = roofline(k2_rays * n_prims * K2_OPS,
                        packed.table.numel() * 4 + k2_out.numel() * 4)
    n_pix = HI_W * HI_H
    k1_bound = roofline(n_pix * k1_ops(cfg), K1_PLANES * n_pix * 4)
    k1d_bound = roofline(dw * dh * k1_ops(cfg), K1_PLANES * dw * dh * 4)
    print(f"phase 6c {card} per kernel at {HI_W}x{HI_H} (ms per call: "
          f"device time | CUDA events; share of the bound by device time): "
          f"trace kernel {d_k2:.4f} | {t_k2:.4f} vs plain {t_k2p:.3f} ms, "
          f"bound {k2_bound[0]:.5f} ms by {k2_bound[1]} ({k2_rays} rays x "
          f"{n_prims} primitives), share {k2_bound[0] / d_k2:.2%}; post "
          f"kernel {d_k1:.4f} | {t_k1:.4f} vs plain {t_k1p:.3f} ms, bound "
          f"{k1_bound[0]:.5f} ms by {k1_bound[1]}, share "
          f"{k1_bound[0] / d_k1:.2%}; post kernel at {dw}x{dh} {d_k1d:.4f} | "
          f"{t_k1d:.4f}, bound {k1d_bound[0]:.5f} ms by {k1d_bound[1]}, "
          f"share {k1d_bound[0] / d_k1d:.2%}", flush=True)

    # ---- 6d. K1's global-memory phases ------------------------------------
    k1_global = k1_global_phase(dev, card, inputs, cfg,
                                {"ms": d_k1, "event_ms": t_k1,
                                 "bound_ms": k1_bound[0]})

    # ---- 7. the cluster kernel vs plain on the dragon's sweeps -----------
    t0 = time.perf_counter()
    dragon = SCENE_BUILDERS["dragon"]().to(dev)
    build_s = time.perf_counter() - t0
    d_params = ray_params(dragon.default_pose, dw, dh, TRACE_FRAME)[None]

    def dragon_frame(c):
        return trace_wavefront_planes(dragon, d_params[0], TRACE_FRAME, dw, dh,
                                      c, "kernel")

    sets = {id(getattr(dragon, k).gmat): k.replace("mesh_clusters", "")
            .lstrip("_") or "full"
            for k in ("mesh_clusters", "mesh_clusters_fine",
                      "mesh_clusters_lod", "mesh_clusters_shadow")}
    calls = record_sweeps(lambda: dragon_frame(cfg))
    full = record_sweeps(lambda: dragon_frame(
        dataclasses.replace(cfg, primary_mesh_lod=False)))[:1]
    assert sets[id(calls[0][0][3])] == "fine", "frame's first sweep"
    assert sets[id(full[0][0][3])] == "full"
    sweep_err, refs = [], []
    for i, (args, got) in enumerate(calls + full):
        ref = cluster_kernel.trace_tiles_plain(*args)
        refs.append(ref)
        res = sweep_contract(got, ref, args)
        sweep_err.append(dict(
            sweep=i, set=sets[id(args[3])], kc=int(args[3].shape[2]),
            clusters=int(args[3].shape[0]), any_hit=bool(args[5]), **res))
    assert any(s["any_hit"] for s in sweep_err), "no any-hit shadow sweep"
    k3_err = max(s["t_abs"] for s in sweep_err if not s["any_hit"])
    print(f"phase 7 cluster kernel vs plain on the dragon at {dw}x{dh}, "
          f"frame {TRACE_FRAME} (scene build {build_s:.2f} s): "
          f"{json.dumps(sweep_err)}", flush=True)

    # ---- 7b. the cull and resolve kernels vs their torch twin ------------
    glue = glue_phase(dev, card, dragon_frame, sets, cfg)

    # ---- 8. cluster goldens on the card ----------------------------------
    cluster_golden_err = {}
    before = kernels.LAUNCHES["clusters"]
    for name, build in FORCED_SCENE_BUILDERS.items():
        r = RaytraceRenderer(build(), 48, 28, device=dev)
        for _ in range(4):
            out = r.render()
        e = max(np.abs(_np(out.top_rgb) - goldens[f"{name}_top"]).max(),
                np.abs(_np(out.bot_rgb) - goldens[f"{name}_bot"]).max())
        assert e <= 2e-3, f"{name}: golden error {e}"
        cluster_golden_err[name] = float(e)
    assert kernels.LAUNCHES["clusters"] > before, "goldens without K3"
    print(f"phase 8 cluster goldens on the card (48x28, 4 frames, kernels): "
          f"{json.dumps(cluster_golden_err)}", flush=True)

    # ---- 9. the dragon at full size --------------------------------------
    dragon_err, dk = renderer_contract(dragon, DRAGON_W, DRAGON_H, dev)
    print(f"phase 9a {card} dragon kernel vs plain renderer at "
          f"{DRAGON_W}x{DRAGON_H}, 4 frames: {json.dumps(dragon_err)}",
          flush=True)
    d_run = timed_frames(dk, DRAGON_FRAMES,
                         ("clusters", "cluster_cull", "post"))
    d_launches = d_run["launches"]
    print(f"phase 9b {card} dragon {DRAGON_W}x{DRAGON_H} ss=1 render_many("
          f"{DRAGON_FRAMES}): {d_run['ms']:.4f} ms/frame (device events), "
          f"{1000.0 / d_run['ms']:.2f} fps, {d_run['rays']} rays/frame (last "
          f"frame), {d_run['mray_s']:.3f} Mray/s; host clock "
          f"{d_run['host_ms']:.4f} ms/frame; launches {d_launches}",
          flush=True)

    # K3 on each sweep of the frame (phase 7's inputs), with its least time.
    k3_sweeps = []
    for i, (args, _) in enumerate(calls):
        ev = cuda_ms(lambda: cluster_kernel.trace_tiles(*args), 20)
        # init, sweep (where a list has entries) and epilogue kernels
        ms = kernel_ms(lambda: cluster_kernel.trace_tiles(*args), 20,
                       3 if sweep_err[i]["entries"] else 2)
        plain = cuda_ms(lambda: cluster_kernel.trace_tiles_plain(*args), 2, 1)
        work = k3_work(args, refs[i])
        k3_sweeps.append(dict(
            sweep=i, set=sets[id(args[3])], any_hit=bool(args[5]), ms=ms,
            event_ms=ev, plain_ms=plain,
            entries=sweep_err[i]["entries"], share=work["bound_ms"] / ms,
            **work))
    t_k3 = sum(x["ms"] for x in k3_sweeps)
    e_k3 = sum(x["event_ms"] for x in k3_sweeps)
    t_k3p = sum(x["plain_ms"] for x in k3_sweeps)
    k3_bound = sum(x["bound_ms"] for x in k3_sweeps)
    print(f"phase 9c {card} cluster kernel on the {len(k3_sweeps)} sweeps of "
          f"the dragon frame (device time | CUDA events): {t_k3:.4f} | "
          f"{e_k3:.4f} ms vs plain {t_k3p:.3f} ms, bound {k3_bound:.5f} ms, "
          f"share {k3_bound / t_k3:.2%}; per sweep {json.dumps(k3_sweeps)}",
          flush=True)

    # ---- 10. the LBVH built on the card --------------------------------
    knot = make_knot()
    soup = [torch.from_numpy(np.ascontiguousarray(x)) for x in
            (knot[:, 0], knot[:, 1], knot[:, 2],
             np.arange(len(knot), dtype=np.int32) % 3)]
    card_soup = [x.to(dev) for x in soup]
    lbvh_err = lbvh_contract(lbvh.build_lbvh(*card_soup),
                             lbvh.build_lbvh(*soup))
    lbvh_ms = cuda_ms(lambda: lbvh.build_lbvh(*card_soup), 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        lbvh.build_lbvh(*card_soup)
    torch.cuda.synchronize()
    lbvh_host = (time.perf_counter() - t0) * 1e3 / 20
    print(f"phase 10 {card} LBVH on the card vs the CPU build, make_knot "
          f"({len(knot)} triangles): {json.dumps(lbvh_err)}; build "
          f"{lbvh_ms:.4f} ms by CUDA events, {lbvh_host:.4f} ms by host "
          f"clock (20 builds)", flush=True)

    # ---- 11. the BVH walk kernel vs the plain walk on the card ----------
    bunny = SCENE_BUILDERS["bunny"]()
    bunny_card = bunny.to(dev)
    lbvh_contract(bunny_card.mesh, bunny.mesh)
    walk_in = walk_cases(dev, HI_W, HI_H)
    walk_res = sweep_kernel_cases(
        walk_in, "bvh", mesh_bvh.intersect_mesh, mesh_bvh.walk,
        lambda bvh: (bvh.heads, bvh.tris), mesh_bvh.walk_work, walk_bound)
    # The launch of each case: headers staged whole where they fit, the
    # large tree's overflow read through L1.
    for name, (bvh, o, *_) in walk_in.items():
        shape = mesh_bvh.walk_shape(bvh.n_nodes, o.shape[0], dev)
        fits = bvh.n_nodes * mesh_bvh.HEAD_F * 4 <= shape["budget"]
        assert (shape["n_shared"] == bvh.n_nodes) == fits, (name, shape)
        walk_res[name]["launch"] = {k: shape[k] for k in (
            "shared_bytes", "n_shared", "blocks", "blocks_per_sm")}
        walk_res[name]["launch"]["nodes"] = bvh.n_nodes
    assert any(r["launch"]["n_shared"] < r["launch"]["nodes"]
               for r in walk_res.values()), "no case reads headers via L1"
    main_walk = walk_in["bunny_primary"]
    o, d = main_walk[1], main_walk[2]
    walk_cpu = hit_contract(mesh_bvh.intersect_mesh(*main_walk),
                            mesh_bvh.intersect_mesh(bunny.mesh, o.cpu(),
                                                    d.cpu(), 1e-3, INF))
    walk_plain_ms = cuda_ms(lambda: mesh_bvh.intersect_mesh(
        *main_walk, impl="plain"), 3, 1)
    ring = SCENE_BUILDERS["exhibit_ring"]().at_time(0.0)
    ring_r = RaytraceRenderer(ring, FB_W, FB_H, device=dev)
    ring_calls = record_calls(ring_r.render, mesh_bvh, "intersect_mesh")
    ring_bits = recorded_bit_contract(ring_calls, mesh_bvh.intersect_mesh)
    assert ring_calls, "no walk sweep in an exhibit_ring frame"
    wm = walk_res["bunny_primary"]
    print(f"phase 11 {card} BVH walk kernel vs the plain walk on the card, "
          f"bit for bit (t, n, u, v, mat, hit), {HI_W}x{HI_H} rays a case "
          f"(ms: kernel device time | the sweep by CUDA events; bound and "
          f"share; work: node visits, triangle tests, rows read, lockstep "
          f"rounds, the most visits of a ray, the share of a warp's visit "
          f"slots used; launch: shared bytes, headers staged, blocks, "
          f"blocks an SM, nodes): {json.dumps(walk_res)}; every walk sweep "
          f"of an exhibit_ring frame at {FB_W}x{FB_H} ({len(ring_calls)} "
          f"sweeps, the glass hero mesh) bit-equal: "
          f"{json.dumps(ring_bits)}; bunny primary rays card vs CPU "
          f"{json.dumps(walk_cpu)}; bunny primary: kernel {wm['ms']:.4f} ms "
          f"| {wm['event_ms']:.4f} ms a sweep vs the plain walk "
          f"{walk_plain_ms:.3f} ms, bound {wm['bound_ms']:.5f} ms by "
          f"{wm['bound_by']}, share {wm['share']:.2%}", flush=True)

    # ---- 12. texture and glass-gem goldens on the card -------------------
    tex_golden_err = {}
    for name in ("glass_gem", "texture_test"):
        before = kernels.LAUNCHES["post"]
        r = RaytraceRenderer(SCENE_BUILDERS[name](), 48, 28, device=dev)
        assert not isinstance(r.packed, trace_kernel.PackedScene), name
        for _ in range(4):
            out = r.render()
        e = max(np.abs(_np(out.top_rgb) - goldens[f"{name}_top"]).max(),
                np.abs(_np(out.bot_rgb) - goldens[f"{name}_bot"]).max())
        assert e <= 2e-3, f"{name}: golden error {e}"
        assert kernels.LAUNCHES["post"] == before + 4, f"{name} without K1"
        tex_golden_err[name] = float(e)
    print(f"phase 12 goldens on the card (48x28, 4 frames, kernels): "
          f"{json.dumps(tex_golden_err)}", flush=True)

    # ---- 13. the bunny and demo_random at 160x90 -------------------------
    b_err, bk = renderer_contract(bunny, FB_W, FB_H, dev)
    b_run = timed_frames(bk, BUNNY_FRAMES, ("post", "bvh"))
    print(f"phase 13a {card} bunny {FB_W}x{FB_H} ss=1: kernel vs plain "
          f"renderer, 4 frames: {json.dumps(b_err)}; render_many("
          f"{BUNNY_FRAMES}): {b_run['ms']:.4f} ms/frame by CUDA events, "
          f"{b_run['host_ms']:.4f} by host clock, {1000.0 / b_run['ms']:.2f} "
          f"fps, {b_run['rays']} rays/frame (last frame), "
          f"{b_run['mray_s']:.4f} Mray/s; launches {b_run['launches']}; BVH "
          f"walk {b_run['bvh']}", flush=True)

    demo = SCENE_BUILDERS["demo_random"]()
    demo_err, demo_r = renderer_contract(demo, FB_W, FB_H, dev)
    demo_pack = demo_r.packed
    assert isinstance(demo_pack, trace_kernel.PackedScene)
    demo_params, demo_frames = trace_inputs(demo_pack.scene, HI_W, HI_H,
                                            TRACE_FRAME, dev)

    def k2_demo():
        return trace_kernel.trace_planes(demo_pack, demo_params, demo_frames,
                                         0, HI_W, HI_H, cfg)

    demo_trace = trace_contract(_np(k2_demo()), _np(
        trace_kernel.trace_planes_plain(demo_pack.scene, demo_params[0],
                                        TRACE_FRAME, HI_W, HI_H, cfg)))
    demo_run = timed_frames(demo_r, DEMO_FRAMES, ("trace", "post"))
    demo_k2 = kernel_ms(k2_demo, 100)
    demo_k2p = cuda_ms(lambda: trace_kernel.trace_planes_plain(
        demo_pack.scene, demo_params[0], TRACE_FRAME, HI_W, HI_H, cfg), 3, 1)
    demo_rows = sum(int(getattr(demo_pack.scene, name).mask.sum())
                    for name, _ in INTERSECTORS)
    demo_out = k2_demo()
    demo_bound = roofline(int(demo_out[11].sum()) * demo_rows * K2_OPS,
                          demo_pack.table.numel() * 4
                          + demo_out.numel() * 4)
    print(f"phase 13b {card} demo_random {FB_W}x{FB_H} ss=1 ({demo_rows} "
          f"primitives): trace kernel vs plain {json.dumps(demo_trace)}; "
          f"kernel vs plain renderer {json.dumps(demo_err)}; render_many("
          f"{DEMO_FRAMES}): {demo_run['ms']:.4f} ms/frame by CUDA events, "
          f"{demo_run['host_ms']:.4f} by host clock, "
          f"{demo_run['mray_s']:.2f} Mray/s; launches {demo_run['launches']}; "
          f"trace kernel {demo_k2:.4f} ms device time vs plain "
          f"{demo_k2p:.3f} ms, bound {demo_bound[0]:.5f} ms by "
          f"{demo_bound[1]}, share {demo_bound[0] / demo_k2:.2%}", flush=True)

    # ---- 14. a video_texture frame on the card ---------------------------
    vt = RaytraceRenderer(SCENE_BUILDERS["video_texture"](), 48, 28,
                          device=dev)
    slot = vt.scene.textures.clone()
    time.sleep(0.05)                       # the synthetic frame moves on
    kernels.reset_launches()
    _, vout = vt.render_many(1)
    torch.cuda.synchronize()
    moved = float((vt.scene.textures - slot).abs().max())
    assert moved > 0.0, "the video slot was not refreshed"
    assert kernels.LAUNCHES["post"] == 1 and kernels.LAUNCHES["trace"] == 0
    assert torch.equal(vt.state.history, vt.state.prev_gbuf[0:3]), "TAA"
    assert torch.isfinite(vout.top_rgb).all()
    print(f"phase 14 {card} video_texture 48x28, one frame: slot refreshed "
          f"(max texel change {moved:.4f}), TAA reset, launches "
          f"{dict(kernels.LAUNCHES)}", flush=True)

    # ---- 15. the voxel DDA kernel vs the plain loop on the card ---------
    cave = SCENE_BUILDERS["voxel_cave"]()
    dda_in = {**dda_cases(dev, HI_W, HI_H),
              **dda_stress_cases(dev, HI_W * HI_H)}
    dda_res = sweep_kernel_cases(
        dda_in, "dda", dda.intersect_voxels, dda.march,
        lambda w: (w.cells, w.origin, w.voxel_size), dda.march_work,
        dda_bound)
    main_dda = dda_in["voxel_cave_primary"]
    o, d = main_dda[1], main_dda[2]
    dda_cpu = hit_contract(dda.intersect_voxels(*main_dda),
                           dda.intersect_voxels(cave.voxels, o.cpu(),
                                                d.cpu(), 1e-3, INF))
    assert dda_cpu["t_bit_equal"] == 1.0, "DDA t not bit-equal to the CPU"
    dda_plain_ms = cuda_ms(lambda: dda.intersect_voxels(
        *main_dda, impl="plain"), 3, 1)
    cave_r = RaytraceRenderer(cave, FB_W, FB_H, device=dev)
    cave_run = timed_frames(cave_r, CAVE_FRAMES, ("post", "dda"))
    dm = dda_res["voxel_cave_primary"]
    print(f"phase 15 {card} voxel DDA kernel vs the plain loop on the card, "
          f"bit for bit (t, n, u, v, mat, hit), {HI_W}x{HI_H} rays a case "
          f"(ms: kernel device time | the sweep by CUDA events; bound and "
          f"share; work: rounds, cells read, lockstep rounds, the most "
          f"rounds of a ray, the share of a warp's round slots used): "
          f"{json.dumps(dda_res)}; voxel_cave primary rays card vs CPU "
          f"{json.dumps(dda_cpu)}; voxel_cave primary: kernel "
          f"{dm['ms']:.4f} ms | {dm['event_ms']:.4f} ms a sweep vs the plain "
          f"loop {dda_plain_ms:.3f} ms, bound {dm['bound_ms']:.5f} ms by "
          f"{dm['bound_by']}, share {dm['share']:.2%}; voxel_cave {FB_W}x"
          f"{FB_H} ss=1 render_many({CAVE_FRAMES}): {cave_run['ms']:.4f} "
          f"ms/frame by CUDA events, {cave_run['host_ms']:.4f} by host "
          f"clock, {cave_run['mray_s']:.3f} Mray/s, launches "
          f"{cave_run['launches']}, DDA {cave_run['dda']}", flush=True)

    # ---- 16. the voxel goldens on the card, the voxel room at 160x90 -----
    from yetanotherconsolegameengine_tpu_torch.scene.voxel_scenes import (
        build_voxel_test_scene)
    from yetanotherconsolegameengine_tpu_torch.world.settings import (
        WorldConfig)
    from yetanotherconsolegameengine_tpu_torch.world.volume_scene import (
        build_minecraft_like)
    voxel_golden = {}
    kernels.reset_launches()
    r = RaytraceRenderer(SCENE_BUILDERS["voxel_test"](), 48, 28, device=dev)
    for _ in range(4):
        out = r.render()
    e = max(np.abs(_np(out.top_rgb) - goldens["voxel_test_top"]).max(),
            np.abs(_np(out.bot_rgb) - goldens["voxel_test_bot"]).max())
    assert e <= 2e-3, f"voxel_test: golden error {e}"
    assert kernels.LAUNCHES["trace"] == 4, "voxel_test without K2"
    voxel_golden["voxel_test"] = float(e)
    with tempfile.TemporaryDirectory() as td:
        vs = build_minecraft_like(
            WorldConfig(chunks_x=2, chunks_y=2, chunks_z=2, view_distance=1),
            world_path=os.path.join(td, "w.vg"), regenerate=True, device=dev)
        try:
            vs.manager.ensure_all_loaded(vs.pos, timeout=120.0)
            isl = vs.update(1.0 / 30.0)
        finally:
            vs.manager.shutdown()
    isl = dataclasses.replace(isl, defaults=(
        float(vs.pos[0]), float(vs.pos[1]) + 10.0, float(vs.pos[2]),
        isl.defaults[3], -0.9, isl.defaults[5]))
    kernels.reset_launches()
    isl_err, rk = renderer_contract(isl, 48, 28, dev)
    assert kernels.LAUNCHES["clusters"] > 0, "island_surface without K3"
    ik = RaytraceRenderer(isl, 48, 28, device=dev)
    for _ in range(4):
        out = ik.render()
    off = np.maximum(
        np.abs(_np(out.top_rgb) - goldens["island_surface_top"]).max(-1),
        np.abs(_np(out.bot_rgb) - goldens["island_surface_bot"]).max(-1))
    voxel_golden["island_surface"] = {
        "kernel_vs_plain": isl_err, "golden_max": float(off.max()),
        "cells_over_2e-3": float((off > 2e-3).mean())}
    print(f"phase 16a goldens on the card (48x28, 4 frames, kernels): "
          f"{json.dumps(voxel_golden)}", flush=True)
    room_err, room_r = renderer_contract(SCENE_BUILDERS["voxel_test"](), FB_W,
                                         FB_H, dev)
    room_run = timed_frames(room_r, VOXEL_FRAMES, ("trace", "post"))
    droom_err, droom_r = renderer_contract(
        build_voxel_test_scene(merge="dda"), FB_W, FB_H, dev, frames=1)
    droom_run = timed_frames(droom_r, VOXEL_DDA_FRAMES, ("post", "dda"))
    assert droom_run["launches"]["trace"] == 0
    print(f"phase 16b {card} voxel_test {FB_W}x{FB_H} ss=1 through K2: "
          f"kernel vs plain renderer, 4 frames {json.dumps(room_err)}; "
          f"render_many({VOXEL_FRAMES}): {room_run['ms']:.4f} ms/frame by "
          f"CUDA events, {room_run['host_ms']:.4f} by host clock, "
          f"{room_run['mray_s']:.2f} Mray/s, launches {room_run['launches']};"
          f" its DDA form (merge='dda'): kernel vs plain renderer, 1 frame "
          f"{json.dumps(droom_err)}; render_many({VOXEL_DDA_FRAMES}): "
          f"{droom_run['ms']:.4f} ms/frame by CUDA events, "
          f"{droom_run['host_ms']:.4f} by host clock, "
          f"{droom_run['mray_s']:.3f} Mray/s, launches "
          f"{droom_run['launches']}, DDA {droom_run['dda']}", flush=True)

    # ---- 17, 18. the default island, on surface clusters and on the DDA --
    orbit, dda_run = island_phases(dev, card)

    # ---- 19. the small-mesh scenes on the card vs the CPU ----------------
    mesh_err, mesh_runs = {}, {}
    for name in ("teapot", "cow", "all_meshes", "museum"):
        scene = SCENE_BUILDERS[name]()
        kernels.reset_launches()
        gk, ok_ = RaytraceRenderer(scene, 48, 28, device=dev).render_many(1)
        assert kernels.LAUNCHES["post"] == 1, f"{name} without K1"
        assert kernels.LAUNCHES["bvh"] > 0, f"{name} without the walk kernel"
        gp, op_ = RaytraceRenderer(scene, 48, 28,
                                   device="cpu").render_many(1)
        err = max(np.abs(_np(ok_.top_rgb) - _np(op_.top_rgb)).max(),
                  np.abs(_np(ok_.bot_rgb) - _np(op_.bot_rgb)).max())
        flips = float(np.mean([(_np(a) != _np(b)).mean()
                               for a, b in zip(gk, gp)]))
        assert err <= 2e-3 and flips < 0.005, (name, err, flips)
        assert int(ok_.rays_traced) == int(op_.rays_traced), name
        mesh_err[name] = {"rgb": float(err), "ansi_flips": flips}
        mesh_runs[name] = timed_frames(RaytraceRenderer(
            scene, FB_W, FB_H, device=dev), MESH_FRAMES,
            ("post", "bvh", "prim"), warmup=1)
    timed19 = {k: [v["ms"], v["host_ms"], v["launches"]]
               for k, v in mesh_runs.items()}
    print(f"phase 19 {card} small-mesh scenes, card (kernels) vs the CPU "
          f"(plain), 48x28, 1 frame: {json.dumps(mesh_err)}; {FB_W}x{FB_H} "
          f"ss=1 render_many({MESH_FRAMES}) ms/frame by CUDA events | host "
          f"clock, launches: {json.dumps(timed19)}", flush=True)

    # ---- 20-22. dynamic scenes, the shell, video mode and scene sync -----
    dyn_runs = dynamic_phases(dev, card)
    shell = shell_phases(dev, card)
    video_sync_phase(dev, card)

    # ---- 23. multi-device row sharding -------------------------------------
    shard = sharding_phases(dev, card, packs, post_in, dragon, cfg)
    nccl = nccl_phase(dev, card, shard, dragon, isl, post_in[HI_W, HI_H],
                      cfg)
    shard["launches"].update(nccl["launches"])

    # ---- 24. the suite's rows on the card ---------------------------------
    suite = suite_phase(dev, card, cfg)

    # ---- 25. the primitive kernel ------------------------------------------
    prim = prim_phase(dev, card)

    def sharded(kernel):
        """Launches of ``kernel`` summed over the ranks of each sharded
        path that takes it."""
        sums = {k: sum(r[kernel] for r in v)
                for k, v in shard["launches"].items()}
        return {k: n for k, n in sums.items() if n}
    shell_launches = {
        "shell_cornell": shell["shell"][1]["launches"],
        "shell_cornell_batch8": shell["shell"][8]["launches"],
        "shell_spinning_mesh": shell["checks"][1]["launches"]}

    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [
        {"name": "trace", "route": "cuda",
         "source": "yetanotherconsolegameengine_tpu_torch/ops/csrc/"
                   "trace_kernel.cu",
         "replaces": "yetanotherconsolegameengine_tpu/ops/pallas_trace.py:1049",
         "launches": launches["trace"],
         "max_abs_err": max(e["radiance_abs"] for e in trace_err.values()),
         "ms": d_k2, "event_ms": t_k2, "plain_ms": t_k2p,
         "bound_ms": k2_bound[0], "share": k2_bound[0] / d_k2,
         "bound_by": k2_bound[1], "library_ms": None,
         "launches_by_path": {"cornell": launches["trace"],
                              "demo_random": demo_run["launches"]["trace"],
                              "voxel_test": room_run["launches"]["trace"],
                              **{k: v["trace"]
                                 for k, v in shell_launches.items()},
                              **sharded("trace"),
                              **{f"suite {k}": v["trace"]
                                 for k, v in suite.items()}},
         "band_ms": shard["timing"]["k2_band_ms"],
         "band_bound_ms": shard["timing"]["k2_band_bound_ms"],
         "demo_random": {"ms": demo_k2, "plain_ms": demo_k2p,
                         "bound_ms": demo_bound[0],
                         "bound_by": demo_bound[1]}},
        {"name": "post", "route": "cuda",
         "source": "yetanotherconsolegameengine_tpu_torch/ops/csrc/"
                   "post_kernel.cu",
         "replaces": "yetanotherconsolegameengine_tpu/ops/pallas_post.py:434",
         "launches": launches["post"],
         "max_abs_err": max(e["rgb"] for e in post_err.values()),
         "ms": d_k1, "event_ms": t_k1, "plain_ms": t_k1p,
         "bound_ms": k1_bound[0], "share": k1_bound[0] / d_k1,
         "bound_by": k1_bound[1], "library_ms": None,
         "launches_by_path": {"cornell": launches["post"],
                              "dragon": d_launches["post"],
                              "bunny": b_run["launches"]["post"],
                              "demo_random": demo_run["launches"]["post"],
                              "voxel_test": room_run["launches"]["post"],
                              "voxel_test_dda": droom_run["launches"]["post"],
                              **{f"island_{k}": v["launches"]["post"]
                                 for k, v in orbit.items()},
                              "island_dda": dda_run["launches"]["post"],
                              **{k: v["launches"]["post"]
                                 for k, v in dyn_runs.items()},
                              **{k: v["post"]
                                 for k, v in shell_launches.items()},
                              **sharded("post"),
                              **{f"suite {k}": v["post"]
                                 for k, v in suite.items()}},
         "band": {"a_ms": shard["timing"]["k1_band_a_ms"],
                  "b_ms": shard["timing"]["k1_band_b_ms"],
                  "a_bound_ms": shard["timing"]["k1_band_a_bound_ms"],
                  "b_bound_ms": shard["timing"]["k1_band_b_bound_ms"],
                  "rows": shard["timing"]["band_rows"],
                  "extended_rows": shard["timing"]["extended_rows"]},
         "sharded_cornell_ms_per_frame": shard["ms"],
         "world1_cornell_ms_per_frame": dict(
             nccl["ms"], unsharded_render=nccl["unsharded_render_ms"]),
         "global_memory": {k: {f: v[f] for f in (
             "ms", "event_ms", "plain_ms", "bound_ms", "bound_by", "share",
             "max_abs_err")} for k, v in k1_global.items()}},
        {"name": "clusters", "route": "cuda",
         "source": "yetanotherconsolegameengine_tpu_torch/ops/csrc/"
                   "cluster_kernel.cu",
         "replaces": "yetanotherconsolegameengine_tpu/ops/mesh_clusters.py:557",
         "launches": d_launches["clusters"], "max_abs_err": k3_err,
         "ms": t_k3, "event_ms": e_k3, "plain_ms": t_k3p,
         "bound_ms": k3_bound, "share": k3_bound / t_k3,
         "bound_by": "operations" if all(
             x["bound_by"] == "operations" for x in k3_sweeps) else "bytes",
         "library_ms": None,
         "launches_by_path": {"dragon": d_launches["clusters"],
                              **{f"island_{k}": v["launches"]["clusters"]
                                 for k, v in orbit.items()},
                              **{k: v["clusters"]
                                 for k, v in shell_launches.items()},
                              **sharded("clusters")}},
        {"name": "cluster_glue", "route": "cuda",
         "source": "yetanotherconsolegameengine_tpu_torch/ops/csrc/"
                   "cluster_glue.cu",
         "replaces": None, "launches": glue_launches(d_launches),
         "max_abs_err": 0.0,
         **{f: glue[f] for f in ("ms", "event_ms", "plain_ms", "bound_ms")},
         "share": glue["bound_ms"] / glue["ms"], "bound_by": "bytes",
         "library_ms": None,
         "launches_by_path": {"dragon": glue_launches(d_launches),
                              **{f"island_{k}":
                                 glue_launches(v["launches"])
                                 for k, v in orbit.items()}},
         "full_set": {f: glue["sweeps"][-1][f] for f in (
             "rays", "clusters", "ms", "event_ms", "plain_ms", "bound_ms",
             "share")}},
        {"name": "bvh", "route": "cuda",
         "source": "yetanotherconsolegameengine_tpu_torch/ops/csrc/"
                   "bvh_kernel.cu",
         "replaces": "yetanotherconsolegameengine_tpu/ops/mesh_bvh.py:364",
         "launches": b_run["launches"]["bvh"],
         "max_abs_err": max(r["max_abs_err"] for r in
                            [*walk_res.values(), *ring_bits]),
         "ms": wm["ms"], "event_ms": wm["event_ms"],
         "plain_ms": walk_plain_ms, "bound_ms": wm["bound_ms"],
         "share": wm["share"], "bound_by": wm["bound_by"],
         "library_ms": None,
         "launches_by_path": {"bunny": b_run["launches"]["bvh"],
                              **{k: v["launches"]["bvh"]
                                 for k, v in mesh_runs.items()},
                              **{k: v["launches"]["bvh"]
                                 for k, v in dyn_runs.items()},
                              **{k: v["bvh"]
                                 for k, v in shell_launches.items()
                                 if v["bvh"]},
                              **sharded("bvh")},
         "cases": {k: {f: v[f] for f in ("ms", "event_ms", "bound_ms",
                                         "share", "rays", "hits")}
                   for k, v in walk_res.items()}},
        {"name": "dda", "route": "cuda",
         "source": "yetanotherconsolegameengine_tpu_torch/ops/csrc/"
                   "dda_kernel.cu",
         "replaces": "yetanotherconsolegameengine_tpu/ops/dda.py:207",
         "launches": dda_run["launches"]["dda"],
         "max_abs_err": max(r["max_abs_err"] for r in dda_res.values()),
         "ms": dm["ms"], "event_ms": dm["event_ms"],
         "plain_ms": dda_plain_ms, "bound_ms": dm["bound_ms"],
         "share": dm["share"], "bound_by": dm["bound_by"],
         "library_ms": None,
         "launches_by_path": {"voxel_cave": cave_run["launches"]["dda"],
                              "voxel_test_dda": droom_run["launches"]["dda"],
                              "island_dda": dda_run["launches"]["dda"],
                              **sharded("dda")},
         "cases": {k: {f: v[f] for f in ("ms", "event_ms", "bound_ms",
                                         "share", "rays", "hits")}
                   for k, v in {**dda_res,
                                **dda_run["dda_cases"]}.items()}},
        {"name": "prim", "route": "cuda",
         "source": "yetanotherconsolegameengine_tpu_torch/ops/csrc/"
                   "prim_kernel.cu",
         "replaces": None, "launches": prim["launches"],
         "max_abs_err": max(r["max_abs_err"] for r in
                            [*prim["frame"], *prim["cases"].values()]),
         **{f: prim["timing"][FB_W * FB_H * 2][f] for f in (
             "ms", "event_ms", "plain_ms", "bound_ms", "bound_by",
             "share")},
         "library_ms": None,
         "launches_by_path": {k: v["launches"]["prim"]
                              for k, v in mesh_runs.items()},
         "shadow_sweep": prim["timing"][FB_W * FB_H * 2 * 8]},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
