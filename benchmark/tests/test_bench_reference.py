"""The frozen reference against the port's plain path, at 24x16 pixels.

The reference (benchmark/reference) is written out on its own; these
tests hold it to the port's plain PyTorch path on the CPU, frame by frame
from a fresh state, for both configurations' scenes and inputs."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.reference import camera, frame, scene as ref_scene
from benchmark.reference.scenes import cornell, museum

FB_W, FB_H = 24, 8


def _cfg():
    from yetanotherconsolegameengine_tpu_torch.config import RenderConfig
    return dataclasses.asdict(RenderConfig())


@pytest.mark.parametrize("name,builder", [("cornell", cornell),
                                          ("museum", museum)])
def test_scene_inputs_equal_the_ports_builder(name, builder):
    from yetanotherconsolegameengine_tpu_torch.scene.builders import \
        SCENE_BUILDERS
    got = check.program_inputs(SCENE_BUILDERS[name]())
    assert check.scene_diff(got, builder.build()) == 0


@pytest.mark.parametrize("name,builder,frames", [("cornell", cornell, 3),
                                                 ("museum", museum, 1)])
def test_frames_equal_the_ports_plain_path(name, builder, frames):
    from yetanotherconsolegameengine_tpu_torch.render.renderer import \
        RaytraceRenderer
    from yetanotherconsolegameengine_tpu_torch.scene.builders import \
        SCENE_BUILDERS
    inputs = builder.build()
    scene = ref_scene.Scene.from_inputs(inputs, "cpu")
    keys = lambda t: {"w", "left"} if t % 2 else set()
    poses = camera.call_poses(keys, 1, 1 / 30, scene.defaults, frames)
    r = RaytraceRenderer(SCENE_BUILDERS[name](), FB_W, FB_H, device="cpu")
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


def test_mesh_box_skip_keeps_every_hit():
    """Testing each mesh object only against the rays that meet its box
    gives what testing every triangle gives, bit for bit."""
    from types import SimpleNamespace

    from benchmark.reference import trace
    scene = ref_scene.Scene.from_inputs(museum.build(), "cpu")
    m = scene.mesh
    every = SimpleNamespace(**vars(m))
    every.groups = [SimpleNamespace(
        idx=torch.arange(m.a.shape[0]), a=m.a, e1=m.e1, e2=m.e2,
        lo=torch.full((3,), -trace.INF), hi=torch.full((3,), trace.INF))]
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
