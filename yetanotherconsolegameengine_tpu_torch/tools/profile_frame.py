"""Where a frame's time goes on the card, every number from one process.

    python3 -m yetanotherconsolegameengine_tpu_torch.tools.profile_frame \
        [--scene dragon] [--size 240x135] [--wall-frames 20] [--prof-frames 5]
        [--ss 1]

Renders a scene of ``SCENE_BUILDERS`` (by default the dragon at 240x135
cells; ss=1 unless ``--ss`` says otherwise, default ``RenderConfig``; a
dynamic scene as its frame at t = 0), or
with ``--scene minecraft_like`` the default streamed island
(``world/volume_scene.py``, settled, one update, seen from 6 above the
spawn at pitch -0.35) and with
``--scene minecraft_like_dda`` the same island forced onto the voxel DDA,
with the kernels (``impl="kernel"``) after three warm-up frames:

1. for a cluster scene, one frame with a CUDA-event pair around every
   cluster sweep (K3): its
   set, tiles, work items, active rays, entries tested (and those the
   serial walk of ``trace_tiles_plain`` visits, of those listed), the
   lane-tests it needs, its least time on the card (``k3_work``) and its
   time; then each sweep on its own, by CUDA events over 20 launches;
2. ``WALL_FRAMES`` frames with the profiler off: ms/frame by a
   synchronised host clock and by CUDA events, rays/frame, the kernel
   wrappers' launches per frame and, for a BVH-mesh or voxel scene, the
   walk's or the DDA's sweeps per frame (``mesh_bvh.STATS``,
   ``dda.STATS``) beside its kernel's launches (one a sweep, no host wait
   inside it);
3. ``PROF_FRAMES`` frames under ``torch.profiler`` with a range around each
   stage (K2, tile cull, the rest of ``intersect_clusters``, K3, the BVH
   walk kernel, the voxel DDA kernel, shadow rays, compaction, post):
   device busy time (the union of device operations) split by the
   innermost stage that encloses each operation, device kernels and
   copies per frame, and the host time inside each stage. The profiler
   can lose the records of launches made back to back, so the records of
   K1, K2, K3, the walk, DDA and primitive kernels are counted against the
   launches their wrappers counted (``kernels.LAUNCHES``); a pass that
   lost any is profiled again, frame by frame with a synchronise after
   each, up to ``TRIES`` passes in all. If every pass lost records, no
   busy or idle share is printed and the tool exits non-zero with the
   counts.

The device idle share is 1 - busy / wall, given both for the profiled
frames' own wall and for step 2's profiler-off wall (device work per frame
does not depend on the profiler; host time does). Writes
``chiprun_out/profile_<scene>[_ss<N>].txt`` under the working directory; exits
non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import sys
import time

import torch

from ..utils.profiling import card_line, timed

# (module attribute, stage label), innermost stages first: an operation
# counts for the first listed stage whose device range encloses it.
STAGES = (
    ("trace_kernel.trace_planes", "K2 trace"),
    ("cluster_kernel.trace_tiles", "K3 cluster sweeps"),
    ("mesh_clusters._tile_cull", "tile cull + list sort (torch)"),
    ("mesh_clusters.intersect_clusters",
     "prefilter, binning sort, unsort, resolve (torch)"),
    ("mesh_bvh.intersect_mesh", "BVH walk kernel"),
    ("dda.intersect_voxels", "voxel DDA kernel"),
    ("trace.transmittance_to_lights", "shadow rays outside the sweep (torch)"),
    ("trace._compact", "compaction (torch)"),
    ("post_kernel.post", "K1 post"),
)
OTHER = "torch wavefront: ray gen, shading, u8 grids"
OUT = "chiprun_out"
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
# The device kernels of which each launch counted in ``kernels.LAUNCHES``
# runs exactly one (ops/csrc): K2's kernel, K1's cooperative kernel or its
# band launch B, K3's epilogue (its sweep is skipped when no list has an
# entry), the walk, the DDA and the primitive kernel.
KERNEL_RECORDS = {"trace": ("trace_kernel",),
                  "post": ("post_persistent", "post_band_tail"),
                  "clusters": ("epilogue_kernel",),
                  "bvh": ("bvh_walk_kernel",),
                  "dda": ("dda_march_kernel",),
                  "prim": ("prim_kernel",)}
TRIES = 3


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
    from ..ops import cluster_kernel
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


def union_ms(intervals) -> float:
    """Length of the union of (start, end) intervals in microseconds, in
    milliseconds."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e3


def kernel_records(names) -> dict:
    """How many of the device operations ``names`` (the profiler's
    demangled kernel names) are records of each wrapper's launches, by
    ``KERNEL_RECORDS``."""
    pats = {k: re.compile(r"(?:^|::|\s)(?:%s)(?:\(|$)" % "|".join(v))
            for k, v in KERNEL_RECORDS.items()}
    counts = dict.fromkeys(KERNEL_RECORDS, 0)
    for name in names:
        for k, pat in pats.items():
            if pat.search(name):
                counts[k] += 1
    return counts


def lost_records(launches: dict, records: dict) -> dict:
    """{wrapper: (launches, records)} for each wrapper whose launches the
    profiler kept fewer records of."""
    return {k: (launches[k], records[k]) for k in KERNEL_RECORDS
            if records[k] < launches[k]}


def device_ops(events):
    """The profiler's device events split into (operations [(start, end,
    name)], stage ranges {label: [(start, end)]}): the profiler also
    reports GPU-side operator and stage ranges as CUDA events, which are
    not device work."""
    from torch.autograd import DeviceType
    host_names = {ev.name for ev in events
                  if ev.device_type != DeviceType.CUDA}
    labels = {label for _, label in STAGES}
    ops, spans = [], collections.defaultdict(list)
    for ev in events:
        if ev.device_type != DeviceType.CUDA:
            continue
        iv = (ev.time_range.start, ev.time_range.end)
        if ev.name in labels:
            spans[ev.name].append(iv)
        elif ev.name not in host_names:   # not a GPU-side operator range
            ops.append(iv + (ev.name,))
    return ops, spans


def busy_by_stage(ops, spans) -> dict:
    """Device time (ms) of ``ops`` [(start, end, name)] grouped by the first
    stage in ``STAGES`` order whose device ranges ``spans`` {label: [(start,
    end)]} enclose the operation; the rest under ``OTHER``. Each group is
    the union of its operations, so the groups sum to the total busy time
    when operations do not overlap."""
    groups = collections.defaultdict(list)
    for s, e, _ in ops:
        label = OTHER
        for _, stage in STAGES:
            if any(a <= s and e <= b for a, b in spans.get(stage, ())):
                label = stage
                break
        groups[label].append((s, e))
    return {k: union_ms(v) for k, v in groups.items()}


def _patch_stages(record_function):
    """Wrap each stage's module attribute in a profiler range; returns a
    function that undoes it."""
    from ..ops import (cluster_kernel, dda, mesh_bvh, mesh_clusters,
                       post_kernel, trace, trace_kernel)
    mods = dict(cluster_kernel=cluster_kernel, mesh_clusters=mesh_clusters,
                mesh_bvh=mesh_bvh, dda=dda, trace=trace,
                post_kernel=post_kernel, trace_kernel=trace_kernel)
    saved = []
    for path, label in STAGES:
        mod_name, attr = path.split(".")
        mod = mods[mod_name]
        fn = getattr(mod, attr)

        def wrapped(*a, _fn=fn, _label=label, **k):
            with record_function(_label):
                return _fn(*a, **k)

        saved.append((mod, attr, fn))
        setattr(mod, attr, wrapped)

    def undo():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return undo


def _sweep_lines(r, scene) -> list:
    from ..ops import cluster_kernel
    names = {id(getattr(scene, k).gmat): k
             for k in ("mesh_clusters", "mesh_clusters_fine",
                       "mesh_clusters_lod", "mesh_clusters_shadow")
             if getattr(scene, k) is not None}
    real = cluster_kernel.trace_tiles
    calls = []

    def timed(*args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(*args)
        b.record()
        calls.append((args, out, a, b))
        return out

    cluster_kernel.trace_tiles = timed
    try:
        r.render_many(1)
    finally:
        cluster_kernel.trace_tiles = real
    torch.cuda.synchronize()
    if not calls:
        return ["no K3 sweeps in this frame"]
    piece, rpb = cluster_kernel.PIECE, cluster_kernel.RAYS_PER_BLOCK
    lines = [f"K3 sweeps of one frame, in order (split schedule: piece "
             f"{piece}, {rpb} rays per block):"]
    total = bound_total = 0.0
    for i, (args, out, a, b) in enumerate(calls):
        ms = a.elapsed_time(b)
        lens, steps = args[0], out[2]
        ref = cluster_kernel.trace_tiles_plain(*args)
        work = k3_work(args, ref)
        items = int(((lens + piece - 1) // piece).sum()) * (256 // rpb)
        active = int((args[4][:, 7] > float("-inf")).sum())
        total += ms
        bound_total += work["bound_ms"]
        lines.append(
            f"  {i}: {names.get(id(args[3]), '?')} any_hit={bool(args[5])} "
            f"tiles={lens.shape[0]} items={items} active_rays={active} "
            f"C={args[3].shape[0]} kc={args[3].shape[2]} "
            f"tested={int(steps.sum())} serial={int(ref[2].sum())} "
            f"listed={int(lens.sum())} lane_tests={work['lane_tests']} "
            f"bound={work['bound_ms']:.5f} ms ({work['bound_by']}) "
            f"{ms:.4f} ms share={work['bound_ms'] / ms:.2%}")
    lines.append(f"K3 total by CUDA events: {total:.4f} ms/frame over "
                 f"{len(calls)} sweeps; bound {bound_total:.5f} ms")
    alone = [cuda_ms(lambda: real(*args), 20) for args, *_ in calls]
    lines.append("K3 per sweep on its own (ms by CUDA events, 20 launches): "
                 + " ".join(f"{ms:.4f}" for ms in alone)
                 + f"; sum {sum(alone):.4f}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="dragon")
    ap.add_argument("--size", default="240x135", help="cells, WxH")
    ap.add_argument("--wall-frames", type=int, default=20)
    ap.add_argument("--prof-frames", type=int, default=5)
    ap.add_argument("--ss", type=int, default=1, help="supersampling")
    args = ap.parse_args(argv)
    W, H = map(int, args.size.split("x"))
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA card", file=sys.stderr)
        return 2

    from torch.profiler import ProfilerActivity, profile, record_function

    from ..ops import dda, kernels, mesh_bvh
    from ..render.renderer import RaytraceRenderer
    from ..scene.builders import SCENE_BUILDERS

    dev = torch.device("cuda", 0)
    lines = [f"card: {card_line(dev)}; scene {args.scene} {W}x{H} cells, "
             f"ss={args.ss}, default RenderConfig, impl=kernel"]
    if args.scene.startswith("minecraft_like"):
        from ..world.volume_scene import build_minecraft_like
        vs = build_minecraft_like(surface_mesh=args.scene == "minecraft_like",
                                  device=dev)
        try:
            scene = vs.update(1.0 / 30.0)
        finally:
            vs.manager.shutdown()
        r = RaytraceRenderer(scene, W, H, args.ss, device=dev,
                             impl="kernel")
        r.set_camera((vs.pos[0], vs.pos[1] + 6.0, vs.pos[2]), 0.0, -0.35)
    else:
        scene = SCENE_BUILDERS[args.scene]()
        if hasattr(scene, "at_time"):   # a dynamic scene: its frame at t = 0
            scene = scene.at_time(0.0)
        scene = scene.to(dev)
        r = RaytraceRenderer(scene, W, H, args.ss, device=dev,
                             impl="kernel")
    r.render_many(3)
    torch.cuda.synchronize()

    # 1. K3 sweeps of one frame.
    lines += _sweep_lines(r, scene)

    # 2. Profiler off.
    n = args.wall_frames
    kernels.reset_launches()
    mesh_bvh.STATS.clear()
    dda.STATS.clear()
    ev_ms, wall_off, (_, out) = timed(lambda: r.render_many(n), n, dev)
    launches = {k: v / n for k, v in kernels.LAUNCHES.items()}
    lines.append(
        f"profiler off, {n} frames: {wall_off:.4f} ms/frame by host clock, "
        f"{ev_ms:.4f} ms/frame by CUDA events; "
        f"{int(out.rays_traced)} rays/frame (last frame); kernel wrapper "
        f"launches per frame {launches}")
    for label, mod, key in (("BVH walk", mesh_bvh, "bvh"),
                            ("voxel DDA", dda, "dda")):
        st = dict(mod.STATS)
        if not st:
            continue
        lines.append(f"{label}: {st['sweeps'] / n:.1f} sweeps/frame, "
                     f"{launches[key]:.1f} kernel launches/frame (one a "
                     f"sweep, no host wait inside it)")

    # 3. Profiler on, with stage ranges; every launch's record kept.
    n = args.prof_frames
    undo = _patch_stages(record_function)
    try:
        for attempt in range(TRIES):
            kernels.reset_launches()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if attempt == 0:
                    r.render_many(n)
                else:
                    for _ in range(n):
                        r.render_many(1)
                        torch.cuda.synchronize()
                torch.cuda.synchronize()
                wall_on = (time.perf_counter() - t0) * 1e3 / n
            ops, spans = device_ops(prof.events())
            launches = dict(kernels.LAUNCHES)
            records = kernel_records(o[2] for o in ops)
            lost = lost_records(launches, records)
            lines.append(
                f"profiled pass {attempt + 1} ("
                f"{'one call' if attempt == 0 else 'a synchronise a frame'}"
                f"): launches counted by the wrappers {launches}, records "
                f"kept {records}")
            if not lost:
                break
    finally:
        undo()
    if lost:
        lines.append(f"records lost in all {TRIES} passes (launches, "
                     f"records) {lost}: no busy or idle share")
        _write(lines, args)
        return 1
    busy = union_ms([o[:2] for o in ops]) / n
    copies = sum(1 for o in ops if o[2].startswith(("Memcpy", "Memset")))
    lines.append(
        f"profiler on, {n} frames: {wall_on:.4f} ms/frame by host clock; "
        f"device busy {busy:.4f} ms/frame; "
        f"{(len(ops) - copies) / n:.1f} kernels and {copies / n:.1f} "
        f"copies/memsets per frame")
    lines.append(f"device idle share: {1.0 - busy / wall_on:.4f} in the "
                 f"profiled frames; {1.0 - busy / wall_off:.4f} against the "
                 f"profiler-off wall")
    lines.append("device busy by stage (ms/frame, share of busy):")
    groups = busy_by_stage(ops, spans)
    for label, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {ms / n:9.4f}  {ms / n / busy:6.1%}  {label}")
    per_kernel = collections.Counter()
    for s, e, name in ops:
        per_kernel[name[:96]] += (e - s) / 1e3 / n
    lines.append("top device operations (ms/frame):")
    for name, ms in per_kernel.most_common(10):
        lines.append(f"  {ms:9.4f}  {name}")
    lines.append("host time inside each stage (ms/frame, profiler on; "
                 "nested stages included in their parents):")
    labels = {label for _, label in STAGES}
    for ev in prof.key_averages():
        if ev.key in labels and ev.cpu_time_total > 0:
            lines.append(f"  {ev.cpu_time_total / 1e3 / n:9.4f}  "
                         f"{ev.count / n:.1f} calls  {ev.key}")

    _write(lines, args)
    return 0


def _write(lines, args) -> None:
    """Print ``lines`` and write them to ``chiprun_out/profile_<scene>``."""
    text = "\n".join(lines)
    os.makedirs(OUT, exist_ok=True)
    tag = "" if args.ss == 1 else f"_ss{args.ss}"
    with open(os.path.join(OUT, f"profile_{args.scene}{tag}.txt"), "w") as f:
        f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    sys.exit(main())
