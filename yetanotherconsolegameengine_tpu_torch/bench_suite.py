"""The benchmark suite: every configuration of the JAX package's
``bench_suite.py``, rendered by the port on the card.

    python -m yetanotherconsolegameengine_tpu_torch.bench_suite [NAME ...]

``NAME`` is a row of ``ROWS``; with none, every row runs, in that order
(the JAX suite's). The first line names the card and its power limit;
then each row prints one JSON line with the JAX row's keys, its metric
string ``"{name} @{fb_w}x{fb_h} ({rays} rays/frame)"``, and:

- ``fps``, ``mrays_per_s``, ``ms_per_frame``: sustained frames, one
  warm-up batch of ``render_many(batch)``, then ``n_batches`` batches
  between CUDA events; ``host_ms_per_frame`` is the host clock over the
  same window. Rows without such a window (the streamed island's
  interactive row) hold null in the two ms columns.
- ``interactive_fps``: the engine's loop, one frame in flight: launch
  frame N with ``render()``, then copy frame N-1's ``fg_ansi`` to the
  host.
- ``batched_interactive_fps_k8``: the ``--batch 8`` loop: K = 8 frames a
  call with ``rgb=True``, one batch in flight whose four planes are copied
  to the host; the window covers exactly ``n_batches`` loop iterations.
- ``kernels``: the kernel wrappers (``ops/kernels.LAUNCHES``: ``trace``
  K2, ``post`` K1, ``clusters`` K3) that launched in the row's loops
  (its warm-up batch included), sorted. It stands for the JAX row's
  ``pallas`` flag: the port routes each scene by
  ``trace_kernel.scene_fits``.

The LBVH row times ``ops/lbvh.build_lbvh`` instead: ``ms`` and
``mtris_per_s`` over 8 back-to-back builds after a warm-up, by CUDA
events, and ``host_ms``.

Every row runs on the card unless ``device="cpu"`` is given; without a
card it raises. On the CPU the ms columns are host-clock times of the
plain PyTorch path, for tests only.
"""

from __future__ import annotations

import contextlib
import json
import math
import sys
import time

import torch

from .devices import resolve_device
from .ops import kernels
from .render.renderer import RaytraceRenderer
from .scene.builders import SCENE_BUILDERS as _B
from .scene.voxel_scenes import build_voxel_test_scene
from .utils.profiling import card_line, timed

ROWS = ("cornell", "mirror", "mirror_ss2", "primitives", "voxel_test",
        "voxel_dda", "bunny", "dragon", "spinning_mesh", "island",
        "island_orbit", "island_orbit_240", "island_dda", "lbvh")
# Rows 1-8, static scenes: (name, label, builder, fb_w, fb_h, keywords of
# bench_scene), at the JAX suite's sizes and batches.
STATIC_ROWS = (
    ("cornell", "Cornell Box", _B["cornell"], 160, 90, {}),
    ("mirror", "Mirror spheres + TAA", _B["mirror_spheres"], 240, 135, {}),
    ("mirror_ss2", "Mirror spheres ss=2 (4x rays)", _B["mirror_spheres"],
     240, 135, dict(batch=400, ss=2)),
    ("primitives", "Primitive showcase", _B["primitives"], 160, 90, {}),
    ("voxel_test", "Voxel room (greedy-meshed)", _B["voxel_test"], 160, 90,
     {}),
    ("voxel_dda", "Voxel DDA room (forced DDA)",
     lambda: build_voxel_test_scene(merge="dda"), 160, 90, dict(batch=60)),
    ("bunny", "Bunny mesh BVH", _B["bunny"], 160, 90, dict(batch=30)),
    # BASELINE.md's north star: a dragon-class mesh (the procedural
    # 598k-triangle stand-in) at the reference's 240x135 cells.
    ("dragon", "Dragon mesh (598k tris)", _B["dragon"], 240, 135,
     dict(batch=30)),
)
DT = 1.0 / 30.0


def launched() -> list:
    """The kernel wrappers that launched since the last reset, sorted."""
    return sorted(k for k, v in kernels.LAUNCHES.items() if v > 0)


def sustained(dispatch, frames: int, n_batches: int, device):
    """One warm-up ``dispatch()`` (a batch of ``frames`` frames returning
    (grids, FrameOutput)), then ``n_batches`` more timed. Returns (ms a
    frame by CUDA events, host ms a frame, the warm-up's last
    FrameOutput)."""
    _, out = dispatch()

    def batches():
        for _ in range(n_batches):
            dispatch()
    ms, host, _ = timed(batches, frames * n_batches, device)
    return ms, host, out


def interactive_fps(render_fn, n: int = 24, warmup: int = 4) -> float:
    """Frames/s of the engine's loop, one frame in flight: launch frame N,
    then copy frame N-1's fg ANSI grid to the host."""
    prev = None
    for _ in range(warmup):
        prev = render_fn()
    t0 = time.perf_counter()
    for _ in range(n):
        out = render_fn()
        prev.fg_ansi.cpu()
        prev = out
    prev.fg_ansi.cpu()
    return n / (time.perf_counter() - t0)


def pipelined_batches(dispatch, k: int, n_batches: int = 6) -> float:
    """Frames/s of a loop of ``dispatch()`` calls (``k`` frames each, a
    tuple of planes) with one batch in flight: launch batch N+1, then copy
    batch N's planes to the host. Two warm-up iterations; the window covers
    exactly ``n_batches`` iterations."""
    inflight = dispatch()
    for _ in range(2):
        nxt = dispatch()
        [g.cpu() for g in inflight]
        inflight = nxt
    t0 = time.perf_counter()
    for _ in range(n_batches):
        nxt = dispatch()
        [g.cpu() for g in inflight]
        inflight = nxt
    return n_batches * k / (time.perf_counter() - t0)


def _emit(row: dict) -> dict:
    print(json.dumps(row), flush=True)
    return row


def bench_scene(name, scene, fb_w, fb_h, batch=2000, n_batches=2, ss=1,
                n=24, k=8, device="cuda") -> dict:
    """A static scene: sustained, interactive and batched columns."""
    dev = resolve_device(device)
    r = RaytraceRenderer(scene, fb_w, fb_h, ss=ss, device=dev)
    kernels.reset_launches()
    ms, host, out = sustained(lambda: r.render_many(batch), batch,
                              n_batches, dev)
    rays = int(out.rays_traced)
    ifps = interactive_fps(r.render, n)
    bifps = pipelined_batches(lambda: r.render_many(k, rgb=True)[0], k)
    return _emit({
        "metric": f"{name} @{fb_w}x{fb_h} ({rays} rays/frame)",
        "fps": 1e3 / ms, "mrays_per_s": rays / ms / 1e3,
        "interactive_fps": ifps, "batched_interactive_fps_k8": bifps,
        "kernels": launched(), "ms_per_frame": ms,
        "host_ms_per_frame": host})


def bench_dynamic(name, make_frame_scene, fb_w, fb_h, n=24, dyn=None,
                  volume=None, batch=120, n_batches=2, k=8,
                  device="cuda") -> dict:
    """A scene that changes every frame (``make_frame_scene(t)``), set as
    not static: the interactive column, plus

    - ``dyn`` (a ``DynamicScene``): sustained columns over
      ``render_many(times=, scene_fn=dyn.at_time)`` batches and the
      batched column;
    - ``volume`` (a ``VolumeScene``): the batched column, K physics ticks
      a call, the batch rendered against the batch-end scene."""
    dev = resolve_device(device)
    r = RaytraceRenderer(make_frame_scene(0.0), fb_w, fb_h, device=dev)
    r.set_scene(r.scene, static=False)
    clock = [0.0]

    def render():
        clock[0] += DT
        r.scene = make_frame_scene(clock[0])
        return r.render()

    kernels.reset_launches()
    ifps = interactive_fps(render, n)
    rays = int(r.render().rays_traced)
    row = {"metric": f"{name} @{fb_w}x{fb_h} ({rays} rays/frame)",
           "interactive_fps": ifps, "ms_per_frame": None,
           "host_ms_per_frame": None}
    if dyn is not None:
        def scan_batch(nf):
            times = [dyn.t + (i + 1) * DT for i in range(nf)]
            dyn.t = times[-1]
            return r.render_many(nf, times=times, scene_fn=dyn.at_time,
                                 rgb=(nf == k))
        ms, host, _ = sustained(lambda: scan_batch(batch), batch, n_batches,
                                dev)
        row.update(fps=1e3 / ms, mrays_per_s=rays / ms / 1e3,
                   ms_per_frame=ms, host_ms_per_frame=host)
        row["batched_interactive_fps_k8"] = pipelined_batches(
            lambda: scan_batch(k)[0], k)
    if volume is not None:
        def vol_batch():
            poses = []
            for _ in range(k):
                sc = volume.update(DT)
                poses.append((tuple(volume.pos), volume.yaw, volume.pitch))
            r.scene = sc
            return r.render_many(k, poses=poses, rgb=True)[0]
        row["batched_interactive_fps_k8"] = pipelined_batches(vol_batch, k)
    row["kernels"] = launched()
    return _emit(row)


def bench_island_orbit(vs, label, n_frames=256, fb_w=160, fb_h=90,
                       device="cuda") -> dict:
    """The loaded island is static between chunk arrivals, so an orbit of
    64 poses around the spawn (6 above it, pitch -0.35), repeated to
    ``n_frames``, rides ``render_many`` as every static scene does: one
    warm-up batch of the orbit, then two timed."""
    dev = resolve_device(device)
    rr = RaytraceRenderer(vs.update(DT), fb_w, fb_h, device=dev)
    eye = vs.pos.copy()
    eye[1] += 6.0
    poses = [(eye, math.pi * 2 * i / 64, -0.35) for i in range(64)]
    batch = (poses * ((n_frames + 63) // 64))[:n_frames]
    kernels.reset_launches()
    ms, host, out = sustained(
        lambda: rr.render_many(len(batch), poses=batch), len(batch), 2, dev)
    rays = int(out.rays_traced)
    return _emit({
        "metric": f"{label} @{fb_w}x{fb_h} ({rays} rays/frame)",
        "fps": 1e3 / ms, "mrays_per_s": rays / ms / 1e3,
        "kernels": launched(), "ms_per_frame": ms,
        "host_ms_per_frame": host})


def bench_lbvh_rebuild(device="cuda", n=8) -> dict:
    """LBVH builds on the device (the scene-switch path, and the spinning
    mesh's per-frame rebuild) over the bunny OBJ when the checkout has it,
    else ``make_knot``'s 3,840 triangles."""
    from .ops.lbvh import build_lbvh
    from .scene.mesh_loader import find_asset, load_obj, make_knot
    dev = resolve_device(device)
    path = find_asset("stanford-bunny.obj")
    tris = load_obj(path, scale=2.0) if path else make_knot()
    v = torch.from_numpy(tris).to(dev)
    a, b, c = (v[:, i].contiguous() for i in range(3))
    mats = torch.zeros(len(tris), dtype=torch.int32, device=dev)
    build_lbvh(a, b, c, mats)

    def builds():
        for _ in range(n):
            build_lbvh(a, b, c, mats)
    ms, host, _ = timed(builds, n, dev)
    return _emit({"metric": f"on-device LBVH rebuild ({len(tris)} tris)",
                  "ms": ms, "mtris_per_s": len(tris) / ms / 1e3,
                  "host_ms": host})


@contextlib.contextmanager
def _island(dev, surface_mesh=True):
    """The default streamed island (on the voxel DDA when not
    ``surface_mesh``), loaded and settled first so that no spawn-time chunk
    load is charged to a frame; its manager's workers stop on exit."""
    from .world.volume_scene import build_minecraft_like
    vs = build_minecraft_like(surface_mesh=surface_mesh, device=dev)
    try:
        vs.manager.ensure_all_loaded(vs.pos)
        vs.update(DT)
        yield vs
    finally:
        vs.manager.shutdown()


def main(names=None, device="cuda") -> None:
    """Run the rows ``names`` (every row when None or empty) in ``ROWS``
    order; an unknown name raises before any row runs."""
    unknown = [x for x in names or () if x not in ROWS]
    if unknown:
        raise ValueError(f"unknown rows {unknown}; rows are {list(ROWS)}")
    sel = set(names or ROWS)
    dev = resolve_device(device)
    print(json.dumps({"card": card_line(dev)}), flush=True)

    for name, label, build, w, h, kw in STATIC_ROWS:
        if name in sel:
            bench_scene(label, build(), w, h, device=dev, **kw)
    if "spinning_mesh" in sel:
        from .scene.showcase_scenes import build_spinning_mesh
        dyn = build_spinning_mesh().to(dev)
        bench_dynamic("Spinning mesh (per-frame device LBVH rebuild)",
                      dyn.at_time, 160, 90, dyn=dyn, device=dev)
    if sel & {"island", "island_orbit", "island_orbit_240"}:
        with _island(dev) as vs:
            label = "Minecraft-like island orbit, sustained"
            if "island" in sel:
                bench_dynamic(
                    "Minecraft-like streamed island (surface clusters)",
                    lambda t: vs.update(DT), 160, 90, n=12, volume=vs,
                    device=dev)
            if "island_orbit" in sel:
                bench_island_orbit(vs, label, device=dev)
            if "island_orbit_240" in sel:
                bench_island_orbit(vs, label, n_frames=128, fb_w=240,
                                   fb_h=135, device=dev)
    if "island_dda" in sel:
        # The same island on the voxel DDA (what surface_mesh=False users
        # get).
        with _island(dev, surface_mesh=False) as vs:
            bench_island_orbit(vs, "Minecraft-like island orbit, forced DDA",
                               n_frames=128, device=dev)
    if "lbvh" in sel:
        bench_lbvh_rebuild(device=dev)


if __name__ == "__main__":
    main(sys.argv[1:])
