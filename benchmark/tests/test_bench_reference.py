"""The frozen reference against the port's plain path, at 24x16 pixels.

The reference (benchmark/reference) is written out on its own; these
tests hold it to the port's plain PyTorch path on the CPU, frame by frame
from a fresh state, for both configurations' scenes and inputs, and for a
small cluster-mesh scene with all three proxy sets (``fine_forced``); the
dragon's inputs equal the port's, and on the card its frames hold the
museum's limits."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.reference import camera, frame, scene as ref_scene
from benchmark.reference.scenes import cornell, dragon, fine_forced, museum

FB_W, FB_H = 24, 8
# The dragon, which has no cell yet, under museum.play's traffic and limits.
DRAGON = {"config": {"scene": "dragon", "fb_w": 240, "fb_h": 135}}


def _cfg():
    from yetanotherconsolegameengine_tpu_torch.config import RenderConfig
    return dataclasses.asdict(RenderConfig())


def _port_scene(name):
    from yetanotherconsolegameengine_tpu_torch.scene.builders import \
        SCENE_BUILDERS
    from yetanotherconsolegameengine_tpu_torch.scene.mesh_scenes import \
        FORCED_SCENE_BUILDERS
    return {**SCENE_BUILDERS, **FORCED_SCENE_BUILDERS}[name]()


@pytest.mark.parametrize("name,builder", [
    ("cornell", cornell), ("museum", museum), ("fine_forced", fine_forced),
    pytest.param("dragon", dragon, marks=pytest.mark.slow)])
def test_scene_inputs_equal_the_ports_builder(name, builder):
    """Equal to the last bit: the tables, and a cluster mesh's four sets
    (triangles, width of a cluster, t_bias) in the order-free form."""
    got = check.program_inputs(_port_scene(name))
    want = check.as_compared(builder.build())
    assert check.scene_diff(got, want) == 0
    if name in ("fine_forced", "dragon"):
        assert {k for k in got if k.startswith("mesh")} == {
            f"{s}.{k}" for s in check.CLUSTER_TABLES
            for k in ("rows", "kc", "t_bias")}


def test_cluster_inputs_count_every_changed_triangle():
    """A triangle dropped, a vertex or an edge moved, a material or a
    t_bias changed each reads as unequal; another packing order does
    not."""
    want = check.as_compared(fine_forced.build())
    scene = _port_scene("fine_forced")
    got = check.program_inputs(scene)
    rows = scene.mesh_clusters_lod.tri_rows
    full = rows.shape[0] - scene.mesh_clusters_lod.kc   # whole clusters
    rows[:full] = rows[:full].flip(0).clone()   # another packing order
    assert check.scene_diff(check.program_inputs(scene), want) == 0
    for key, change in (("mesh_lod.rows", lambda r: r[:-1]),
                        ("mesh_fine.t_bias", lambda r: r + 1e-9)):
        bad = dict(got, **{key: change(got[key])})
        assert check.scene_diff(bad, want) > 0, key
    for col in (0, 4, 12):
        bad = dict(got, **{"mesh_shadow.rows": got["mesh_shadow.rows"].copy()})
        bad["mesh_shadow.rows"][7, col] += 1.0
        assert check.scene_diff(bad, want) == 1


@pytest.mark.parametrize("name,builder,frames", [
    ("cornell", cornell, 3), ("museum", museum, 1),
    ("fine_forced", fine_forced, 3)])
def test_frames_equal_the_ports_plain_path(name, builder, frames):
    from yetanotherconsolegameengine_tpu_torch.render.renderer import \
        RaytraceRenderer
    inputs = builder.build()
    scene = ref_scene.Scene.from_inputs(inputs, "cpu")
    keys = lambda t: {"w", "left"} if t % 2 else set()
    poses = camera.call_poses(keys, 1, 1 / 30, scene.defaults, frames)
    r = RaytraceRenderer(_port_scene(name), FB_W, FB_H, device="cpu")
    state = frame.init_state(FB_W, 2 * FB_H, "cpu", torch.float32)
    for c in range(frames):
        _, out = r.render_many(1, poses=poses[c][1])
        want, state = frame.render_frames(scene, _cfg(), FB_W, FB_H,
                                          poses[c][1], scene.defaults[5],
                                          state, c + 1)
        top, bot, fg, bg, rays = want[0]
        np.testing.assert_allclose(out.top_rgb.numpy(), top.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(out.bot_rgb.numpy(), bot.numpy(),
                                   atol=1e-6)
        assert np.array_equal(out.fg_ansi.numpy(), fg.numpy())
        assert np.array_equal(out.bg_ansi.numpy(), bg.numpy())
        assert int(out.rays_traced) == rays
        np.testing.assert_allclose(r.state.history.numpy(),
                                   state["history"].numpy(), atol=1e-6)
        assert float(r.state.ae_exposure) == pytest.approx(
            float(state["ae"]), rel=1e-6)


def test_terminal_decodes_the_ports_encoders():
    """The reference terminal shows what the port's native diff encoder
    and its Python full-frame encoder wrote."""
    from yetanotherconsolegameengine_tpu_torch.engine import \
        terminal_renderer
    from benchmark.reference.terminal import Screen
    rng = np.random.default_rng(0)
    g0 = np.full((5, 7), 0x2580, np.int32)
    f0, b0 = (rng.integers(0, 256, (5, 7)).astype(np.int32)
              for _ in range(2))
    g1, f1, b1 = g0.copy(), f0.copy(), b0.copy()
    f1[2, 3:6] = (f1[2, 3:6] + 7) % 256
    b1[4, 0] = (b1[4, 0] + 1) % 256
    full = terminal_renderer._py_encode(g0, f0, b0, 1)
    s = Screen(np.full((5, 7), 0x20), np.zeros((5, 7)), np.zeros((5, 7)))
    s.feed(full)
    assert (s.glyph == g0).all() and (s.fg == f0).all() and (s.bg == b0).all()
    backend = terminal_renderer.ANSITerminalRenderer(out_fd=-1)
    backend._prev = (g0, f0, b0)
    data = backend._encode_native(g1, f1, b1, 1)
    if data is None:
        pytest.skip("no C++ compiler for the native encoder")
    s = Screen(g0, f0, b0)
    s.feed(data)
    assert (s.glyph == g1).all() and (s.fg == f1).all() and (s.bg == b1).all()


def test_call_poses_replay_the_fly_camera():
    """camera.call_poses equals the port's FlyCamera driven the same way,
    for one frame a tick and for a batch of 8 replayed at dispatch."""
    from yetanotherconsolegameengine_tpu_torch.engine.fly_camera import \
        FlyCamera

    class Keys:
        def __init__(self, held):
            self.held = held

        def is_key_down(self, k):
            return k in self.held

    keys = lambda t: [{"w", "a"}, {"left"}, set(), {"up", "q"}][t % 4]
    defaults = (0.0, 1.0, 3.0, 0.1, -0.05, 60.0)
    got = camera.call_poses(keys, 1, 1 / 30, defaults, 9)
    cam = FlyCamera()
    cam.set_pose(defaults[:3], defaults[3], defaults[4])
    for t in range(9):
        cam.update(Keys(keys(t)), 1 / 30)
        pos, yaw, pitch = got[t][1][0]
        assert pos == [float(np.float32(v)) for v in cam.pos]
        assert (yaw, pitch) == (float(np.float32(cam.yaw)),
                                float(np.float32(cam.pitch)))
    got = camera.call_poses(keys, 8, 1 / 30, defaults, 3)
    assert [tick for tick, _ in got] == [0, 1, 9]


def _icosphere_scene():
    """A 20,480-triangle mesh beside a box."""
    s = ref_scene.SceneBuilder("icosphere")
    s.box((1.5, 0.0, -9.0), (2.5, 1.0, -8.0), ref_scene.Material())
    s.mesh(ref_scene.transform_mesh(ref_scene.icosphere(5), 1.6,
                                    (0.0, 1.2, -8.0)),
           ref_scene.Material.solid((0.9, 0.9, 0.9)))
    return s.build()


@pytest.mark.parametrize("builder", [museum.build, _icosphere_scene])
def test_mesh_box_skip_keeps_every_hit(builder):
    """Testing each mesh object only against the rays that meet its box,
    and each spatial group only against those that meet the group's box,
    gives what testing every triangle as one group gives, bit for bit."""
    from types import SimpleNamespace

    from benchmark.reference import trace
    scene = ref_scene.Scene.from_inputs(builder(), "cpu")
    m = scene.mesh
    N = m.a.shape[0]
    assert N >= 2_000 and sum(o.groups.lo.shape[0] for o in m.objects) > 30
    every = SimpleNamespace(**vars(m))
    every.objects = [SimpleNamespace(
        lo=torch.full((3,), -trace.INF), hi=torch.full((3,), trace.INF),
        groups=SimpleNamespace(
            idx=torch.arange(N)[None], a=m.a[None], e1=m.e1[None],
            e2=m.e2[None], lo=torch.full((1, 3), -trace.INF),
            hi=torch.full((1, 3), trace.INF)))]
    g = torch.Generator().manual_seed(3)
    P = 3000
    o = torch.rand(P, 3, generator=g) * torch.tensor([24.0, 5.0, 16.0]) \
        + torch.tensor([-12.0, 0.0, -14.0])
    aim = torch.tensor([[-8.0, 1.5, -8.0], [0.0, 1.2, -8.0],
                        [8.0, 1.5, -8.0]])[torch.randint(0, 3, (P,),
                                                         generator=g)]
    d = aim + 0.8 * torch.randn(P, 3, generator=g) - o
    d[:50] = torch.randn(50, 3, generator=g)
    d[50:80, 0] = 0.0           # flat in x, inside and outside the boxes
    d[80:90] = 0.0              # no direction at all
    o[90:120] = 2.9e30          # rays parked far away
    d = d / d.norm(dim=1, keepdim=True).clamp(min=1e-20)
    tmin = torch.full((P,), 1e-3)
    tclip = torch.full((P,), trace.INF)
    tclip[200:400] = 5.0
    got = trace.mesh(m, o, d, tmin, tclip)
    want = trace.mesh(every, o, d, tmin, tclip)
    assert int(want.hit.sum()) > 300
    for k in ("t", "n", "u", "v", "mat", "hit"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def test_each_population_meets_its_own_mesh_set():
    """Round 0 meets the fine set, later rounds the LOD set, shadow rays
    the shadow set; with the knobs off every population meets the full
    mesh; a proxy set starts at its t_bias; a scene with no proxy sets
    routes every population to its mesh."""
    from benchmark.reference import trace
    s = ref_scene.Scene.from_inputs(fine_forced.build(), "cpu")
    on = {"primary_mesh_lod": True, "secondary_mesh_lod": True}
    off = {"primary_mesh_lod": False, "secondary_mesh_lod": False}
    sets = {p: trace.mesh_set(s, on, p)
            for p in ("primary", "bounce", "shadow")}
    assert sets == {"primary": s.mesh_fine, "bounce": s.mesh_lod,
                    "shadow": s.mesh_shadow}
    assert [trace.mesh_set(s, off, p) for p in sets] == [s.mesh] * 3
    assert trace.mesh_set(s, dict(on, secondary_mesh_lod=False),
                          "shadow") is s.mesh
    assert trace.mesh_set(s, dict(on, primary_mesh_lod=False),
                          "primary") is s.mesh
    assert 0.0 == s.mesh.t_bias == s.mesh_fine.t_bias \
        < s.mesh_lod.t_bias < s.mesh_shadow.t_bias
    museum_scene = ref_scene.Scene.from_inputs(museum.build(), "cpu")
    assert {trace.mesh_set(museum_scene, {}, p) is museum_scene.mesh
            for p in sets} == {True}

    # A ray 0.2 in front of the sphere (t_bias of the LOD set 0.41): the
    # full set is met at about 0.2, the LOD set only on the far side.
    o = torch.tensor([[0.0, 0.9, -2.4 + 0.65 + 0.2]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    near = trace.intersect(s, o, d, 1e-3, trace.INF, s.mesh)
    far = trace.intersect(s, o, d, 1e-3, trace.INF, s.mesh_lod)
    assert near.hit.all() and far.hit.all()
    assert 0.15 < float(near.t) < 0.25
    assert float(far.t) > 1.0 > s.mesh_lod.t_bias


def test_trace_passes_each_sweep_its_population(monkeypatch):
    """trace_pixels meets the fine set in round 0 and the LOD set after
    it; its shadow rays meet the shadow set."""
    import sys

    from benchmark.reference import trace
    s = ref_scene.Scene.from_inputs(fine_forced.build(), "cpu")
    seen = []
    real = trace.intersect

    def spy(scene, o, d, tmin, tmax, mesh_tb):
        seen.append((sys._getframe(1).f_code.co_name, mesh_tb))
        return real(scene, o, d, tmin, tmax, mesh_tb)
    monkeypatch.setattr(trace, "intersect", spy)
    pos = torch.tensor([[0.0, 1.3, 1.2]])
    rows = frame.camera_rows(pos, torch.zeros(1), torch.zeros(1),
                             torch.tensor([60.0]), 16, 16, torch.ones(1))
    o, d, px, py = frame.primary_rays(rows[0], 16, 16)
    seed = frame.pixel_seed(px, py, 1, 7).reshape(-1)
    trace.trace_pixels(s, o, d, seed, _cfg())
    camera_rays = [m for f, m in seen if f == "trace_pixels"]
    shadow_rays = [m for f, m in seen if f == "transmittance"]
    assert camera_rays[0] is s.mesh_fine and len(camera_rays) > 1
    assert all(m is s.mesh_lod for m in camera_rays[1:])
    assert shadow_rays and all(m is s.mesh_shadow for m in shadow_rays)


@pytest.mark.parametrize("traffic", ["play", "batch8"])
def test_key_schedule_holds_every_segment_and_comes_back(traffic):
    """Each seed's cycle holds the same segments in another order; after
    the cycle the fly camera is back at its start pose, and on the way yaw
    and pitch stay within 60 degrees and the camera above the floor."""
    import json
    import math
    from pathlib import Path

    from benchmark import keys
    tr = json.loads((Path(keys.__file__).parent / "traffic"
                     / f"{traffic}.json").read_text())
    segs = keys.segments(tr)
    ticks = sum(n * (2 if held else 1) for held, n in segs)
    assert all(n % 8 == 0 for _, n in segs)
    start = list(cornell.build()["defaults"][:5])
    runs = []
    for seed in (5, 2**31 + 11):
        sched = keys.KeySchedule(tr, seed)
        seq = [sched.keys_at(t) for t in range(ticks)]
        pose, worst = [float(v) for v in start], 0.0
        for t, held in enumerate(seq):
            pose = camera.step(pose, held, tr["dt"])
            worst = max(worst, abs(pose[3] - start[3]),
                        abs(pose[4] - start[4]))
            assert pose[1] > 0.0
        assert np.allclose(pose, start, atol=1e-4)
        assert worst <= math.radians(60.0)
        runs.append(seq)
    assert runs[0] != runs[1]
    assert sorted(map(sorted, runs[0])) == sorted(map(sorted, runs[1]))


@pytest.mark.cuda
def test_the_dragon_holds_the_museum_limits_on_the_card(card):
    """The dragon at 240x135 under museum.play's traffic and limits, three
    seeds: every number within its limit; the bfloat16 control fails one."""
    from benchmark.run import run_cell
    for seed in (2**31 + 41, 2**31 + 42, 2**31 + 43):
        result, _, errors = run_cell("museum.play", seed, 3.0, 0,
                                     overrides=DRAGON, control=True)
        limits = {k: v["limit"] for k, v in result["check"].items()}
        assert result["correct"], (result["check"], errors)
        assert any(result["control"][k] > limits[k]
                   for k in check.CONTROL_NUMBERS), result["control"]
