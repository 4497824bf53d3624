"""The benchmark's yardstick for device traces and kernels' least times.

Copied from the port's ``tools/profile_frame.py`` and ``utils/profiling.py``
(``union_ms``, ``device_ops``, ``busy_by_stage``, ``kernel_records``,
``lost_records``, ``roofline`` and its peaks, ``card_line``) and from the
operation and byte counts of the port's ``chip_smoke.py`` (K1, K2), so
that later changes to those tools leave the benchmark's numbers as they
are.

Peaks: one H100 SXM at 700 W by the data sheet, fp32 outside the tensor
cores and HBM3: bound = max(operations / 67 TFLOP/s, bytes / 3.35 TB/s).
"""

from __future__ import annotations

import collections
import re
import subprocess

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# (module attribute of the port, stage label), innermost first: a device
# operation counts for the first listed stage whose range encloses it.
STAGES = (
    ("trace_kernel.trace_planes", "K2 trace"),
    ("cluster_kernel.trace_tiles", "K3 cluster sweeps"),
    ("mesh_clusters.intersect_clusters", "cluster sweep host side (torch)"),
    ("mesh_bvh.intersect_mesh", "BVH walk kernel"),
    ("dda.intersect_voxels", "voxel DDA kernel"),
    ("trace.transmittance_to_lights", "shadow loop (torch)"),
    ("post_kernel.post", "K1 post"),
)
OTHER = "torch wavefront and glue"

# The device kernels each counted launch of ``ops/kernels.LAUNCHES`` runs
# exactly once (the port's ops/csrc).
KERNEL_RECORDS = {"trace": ("trace_kernel",),
                  "post": ("post_persistent", "post_band_tail"),
                  "clusters": ("epilogue_kernel",),
                  "bvh": ("bvh_walk_kernel",),
                  "dda": ("dda_march_kernel",)}

# K1: fp32 operations a pixel under the default RenderConfig (the TAA's
# 3x3 clamp 100, three 5x5 a-trous passes of 750, the exposure sample 10,
# the tail 50), and the 4-byte planes it must read and write once a pixel
# (11 of the G-buffer, 5 of the previous one, 3 of history; 6 RGB planes
# and the ANSI plane out).
K1_OPS_PER_PX = 100 + 3 * 750 + 10 + 50
K1_PLANES = 11 + 5 + 3 + 7
# K2: its packed table's floats a row of each table (``trace_kernel.
# _ROW_FIELDS``), 16 a material and 10 globals; it writes 12 planes.
K2_ROW_FLOATS = {"spheres": 5, "boxes": 7, "rects": 7, "cylinders": 7,
                 "disks": 8, "planes": 5, "triangles": 13, "lights": 7}
K2_MATERIAL_FLOATS = 16
K2_GLOBAL_FLOATS = 10
K2_PLANES = 12


def roofline(ops: float, nbytes: float) -> float:
    """Least milliseconds for ``ops`` fp32 operations moving ``nbytes``."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3


def k1_bound_ms(px: int) -> float:
    return roofline(px * K1_OPS_PER_PX, K1_PLANES * 4 * px)


def k2_bound_ms(px: int, inputs: dict) -> float:
    """K2's least time a launch by its bytes: the packed table of the
    scene ``inputs`` read once, the 12 planes written once."""
    floats = sum(inputs[f"{t}.mat" if t != "lights" else "lights.pos"]
                 .shape[0] * w for t, w in K2_ROW_FLOATS.items())
    floats += inputs["materials.albedo"].shape[0] * K2_MATERIAL_FLOATS
    floats += K2_GLOBAL_FLOATS
    return roofline(0, floats * 4 + K2_PLANES * 4 * px)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def union_ms(intervals) -> float:
    """Length of the union of (start, end) intervals in us, in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e3


def device_ops(events):
    """The profiler's device events as (operations [(start, end, name)],
    stage ranges {label: [(start, end)]}); GPU-side operator and range
    annotations are not device work."""
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
        elif ev.name not in host_names:
            ops.append(iv + (ev.name,))
    return ops, spans


def host_ranges(events, names):
    """[(start, end, name)] of the host-side ranges named ``names``."""
    from torch.autograd import DeviceType
    return [(ev.time_range.start, ev.time_range.end, ev.name)
            for ev in events
            if ev.device_type != DeviceType.CUDA and ev.name in names]


def busy_by_stage(ops, spans) -> dict:
    """Device ms of ``ops`` grouped by the first stage in ``STAGES`` whose
    device ranges enclose the operation; the rest under ``OTHER``."""
    groups = collections.defaultdict(list)
    for s, e, _ in ops:
        label = OTHER
        for _, stage in STAGES:
            if any(a <= s and e <= b for a, b in spans.get(stage, ())):
                label = stage
                break
        groups[label].append((s, e))
    return {k: union_ms(v) for k, v in groups.items()}


def kernel_records(names) -> dict:
    pats = {k: re.compile(r"(?:^|::|\s)(?:%s)(?:\(|$)" % "|".join(v))
            for k, v in KERNEL_RECORDS.items()}
    counts = dict.fromkeys(KERNEL_RECORDS, 0)
    for name in names:
        for k, pat in pats.items():
            if pat.search(name):
                counts[k] += 1
    return counts


def lost_records(launches: dict, records: dict) -> dict:
    return {k: (launches[k], records[k]) for k in KERNEL_RECORDS
            if records[k] < launches[k]}


def patch_stages(record_function):
    """Wrap each stage's module attribute of the port in a profiler range;
    returns a function that undoes it."""
    import importlib
    saved = []
    for path, label in STAGES:
        mod_name, attr = path.split(".")
        mod = importlib.import_module(
            f"yetanotherconsolegameengine_tpu_torch.ops.{mod_name}")
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
