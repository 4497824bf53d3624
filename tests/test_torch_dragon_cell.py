"""The ``dragon.play`` cell on the CPU: the dragon's own shape at toy
scale forced onto cluster tables, its frames against the benchmark's
frozen reference under the cell's limits, the cluster sweep's spans and
counters, and the cell as ``benchmark/spec.py`` loads it."""

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import check, keys, spec
from benchmark.reference import camera, frame, scene as ref_scene
from benchmark.reference.scenes import dragon as ref_dragon
from yetanotherconsolegameengine_tpu_torch.config import RenderConfig
from yetanotherconsolegameengine_tpu_torch.ops import kernels, mesh_clusters
from yetanotherconsolegameengine_tpu_torch.render.renderer import \
    RaytraceRenderer
from yetanotherconsolegameengine_tpu_torch.scene import mesh_scenes
from yetanotherconsolegameengine_tpu_torch.scene.mesh_loader import (
    make_dragon, transform_mesh)
from yetanotherconsolegameengine_tpu_torch.scene.tables import SceneBuilder
from yetanotherconsolegameengine_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CELL = "dragon.play"
FB_W, FB_H = 24, 8
SEG_U, SEG_V = 96, 32          # 6,080 triangles
BUDGETS = {"fine": 2048, "lod": 512, "shadow": 128}
CALLS = 3
SPANS = ("clusters.sweep", "clusters.cull", "clusters.resolve")
SETS = ("full", "fine", "lod", "shadow")


def _port_scene():
    """The program's dragon scene (``mesh_scenes.build_dragon_scene``) with
    the toy dragon, forced onto cluster tables and proxy sets."""
    s = SceneBuilder("dragon")
    mesh_scenes._stage(s)
    tris = mesh_scenes._auto_ground(transform_mesh(
        make_dragon(SEG_U, SEG_V), normalize=True, scale=2.6,
        translate=(0.0, 0.0, -3.5)))
    s.add_mesh_triangles(tris, mesh_scenes.SWATCH["gold"])
    mid = s._mesh_tris[-1][1]
    s.set_camera((0.0, 1.6, 1.5), fov=60.0)
    return s.build(clusters=mesh_scenes.forced_cluster_sets(
        tris, np.full(tris.shape[0], mid, np.int32), **BUDGETS))


def _ref_inputs():
    """The reference's dragon (``reference/scenes/dragon.py``) with the toy
    dragon and the same forced sets."""
    s = ref_scene.SceneBuilder("dragon")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.04
    s.xz_rect(-12.0, 12.0, -12.0, 6.0, 0.0,
              ref_scene.Material.checker((0.82, 0.82, 0.82),
                                         (0.2, 0.2, 0.2), 0.75,
                                         specular=0.05))
    s.light((2.5, 5.0, 2.0), (1.0, 0.97, 0.9), 120.0)
    s.light((-3.0, 4.0, -1.0), (0.85, 0.9, 1.0), 60.0)
    s.bg_top = (0.55, 0.75, 1.0)
    s.bg_bottom = (0.95, 0.98, 1.0)
    tris = ref_scene.transform_mesh(ref_dragon.make_dragon(SEG_U, SEG_V),
                                    2.6, (0.0, 0.0, -3.5))
    s.mesh(ref_scene.on_floor(tris, 0.0),
           ref_scene.Material.solid((0.95, 0.78, 0.25), specular=0.5,
                                    reflectivity=0.35))
    s.force_clusters(BUDGETS)
    s.camera((0.0, 1.6, 1.5), fov=60.0)
    return s.build()


@pytest.fixture(scope="module")
def cell():
    return spec.load_cell(ROOT, CELL)


@pytest.fixture(scope="module")
def scenes():
    return _port_scene(), _ref_inputs()


def _poses(cell, defaults, calls):
    sched = keys.KeySchedule(cell.traffic, 2**31 + 19)
    return camera.call_poses(sched.keys_at, 1, float(cell.traffic["dt"]),
                             defaults, calls)


def _renderer(cell, scene):
    cfg = RenderConfig(**cell.config["render_config"])
    return RaytraceRenderer(scene, FB_W, FB_H, cfg=cfg, device="cpu")


def test_toy_dragon_frames_hold_the_cells_limits(cell, scenes):
    """Equal inputs (all four triangle sets), then ``play`` calls through
    ``render_many`` against the reference from a fresh state, every frame
    and state number within ``checks/dragon.play.json``."""
    port, inputs = scenes
    assert check.scene_diff(check.program_inputs(port),
                            check.as_compared(inputs)) == 0
    ref = ref_scene.Scene.from_inputs(inputs, "cpu")
    r = _renderer(cell, port)
    assert check.settings_diff(r.cfg, cell) == 0
    poses = _poses(cell, ref.defaults, CALLS)
    state = frame.init_state(FB_W, 2 * FB_H, "cpu", torch.float32)
    shown = SimpleNamespace(rgb=False)
    limits = cell.limits
    for c in range(CALLS):
        _, out = r.render_many(1, poses=poses[c][1])
        want, state = frame.render_frames(ref, dict(
            cell.config["render_config"]), FB_W, FB_H, poses[c][1],
            ref.defaults[5], state, c + 1)
        got = (out.top_rgb.numpy(), out.bot_rgb.numpy(),
               out.fg_ansi.numpy(), out.bg_ansi.numpy())
        nums = check._frame_numbers(got, check._shown(shown, 0, want[0]))
        nums.update(check._state_numbers(r.state, state))
        assert int(out.rays_traced) == want[0][4]
        for k, v in nums.items():
            assert v <= limits[k], (c, k, v, limits[k])


def _sweeps_of(monkeypatch):
    """Record the P of every ``intersect_clusters`` call."""
    seen = []
    real = mesh_clusters.intersect_clusters

    def spy(mc, o, *a, **k):
        seen.append(o.shape[0])
        return real(mc, o, *a, **k)
    monkeypatch.setattr(mesh_clusters, "intersect_clusters", spy)
    return seen


def _frames_syncs(cell, scene, ref_defaults):
    """Two fresh frames under a recording profiler; the sync sites."""
    r = _renderer(cell, scene)
    poses = _poses(cell, ref_defaults, 2)
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU]):
        for c in range(2):
            r.render_many(1, poses=poses[c][1])
    return dict(profiling.SYNCS)


def test_cluster_sweep_spans_and_counters(cell, scenes, monkeypatch):
    """Under a recording profiler the three spans open once a sweep; the
    sweep counter counts every ``intersect_clusters`` call, the four
    per-set counters sum to it, ``clusters.rays`` is the summed P; the
    counters add no host wait."""
    port, inputs = scenes
    defaults = ref_scene.Scene.from_inputs(inputs, "cpu").defaults
    seen = _sweeps_of(monkeypatch)
    syncs = _frames_syncs(cell, port, defaults)
    n = len(seen)
    assert n >= 4   # round 0, a later round and shadow rays, two frames
    for name in SPANS:
        assert profiling.SPANS[name][0] == n, name
    assert profiling.SPANS["clusters.sweep"][1] >= (
        profiling.SPANS["clusters.cull"][1]
        + profiling.SPANS["clusters.resolve"][1])
    counts = profiling.COUNTS
    assert counts["clusters.sweeps"] == n
    assert sum(counts[f"clusters.sweeps.{s}"] for s in SETS) == n
    assert counts["clusters.sweeps.fine"] == 2   # round 0 of each frame
    assert counts["clusters.sweeps.lod"] > 0
    assert counts["clusters.sweeps.shadow"] > 0
    assert counts["clusters.rays"] == sum(seen)

    # The same frames with the cluster counters dropped: the same sites,
    # each as often.
    real_count = profiling.count
    monkeypatch.setattr(profiling, "count", lambda name, k=1: None if
                        name.startswith("clusters.") else real_count(name, k))
    assert _frames_syncs(cell, port, defaults) == syncs
    assert "clusters.sweeps" not in profiling.COUNTS
    assert set(syncs) <= {"renderer.pose_upload", "camera.world_up",
                          "trace.round_live", "trace.shadow_live",
                          "trace.compact", "cluster_kernel.live",
                          "mesh_clusters.bound_upload",
                          "renderer.frame_index"}


def test_the_cell_loads_by_name(cell):
    """Its configuration, limits (the museum's, but its own flips and
    exposure limits) and traffic; ``lag_p95_ms`` and ``setup_s`` end to
    end; the six cluster metrics per layer; the default
    ``RenderConfig``."""
    assert (cell.config["scene"], cell.config["fb_w"], cell.config["fb_h"],
            cell.config["ss"]) == ("dragon", 240, 135, 1)
    assert cell.traffic["batch"] == 1
    museum = json.loads((ROOT / "benchmark" / "checks" / "museum.play.json")
                        .read_text())["limits"]
    own = ("ansi_flips", "screen_flips", "exposure_rel")
    assert set(cell.limits) == set(museum)
    assert {k: v for k, v in cell.limits.items() if k not in own} \
        == {k: v for k, v in museum.items() if k not in own}
    assert all(museum[k] < cell.limits[k] for k in own)
    assert {m["name"] for m in cell.end_to_end} == {"lag_p95_ms", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "k3.device_ms", "k3.roofline_share", "clusters.torch_device_ms",
        "clusters.host_ms", "clusters.sweeps", "clusters.kernel_share"}
    assert cell.config["render_config"] == dataclasses.asdict(RenderConfig())
