"""The wavefront's CUDA graphs (``ops/trace.py``) where a CPU can hold
them: when they engage, the counts a replay adds, the refusal of a state
that moved, and the segments' homes through a stand-in capture whose
replay reruns the captured function, bit for bit the eager frames. The
card's own graphs are tested in ``test_torch_cuda.py``."""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from yetanotherconsolegameengine_tpu_torch.config import DEFAULT_CONFIG
from yetanotherconsolegameengine_tpu_torch.core import sampler
from yetanotherconsolegameengine_tpu_torch.core.camera import (
    make_jittered_rays, pixel_grid, ray_params)
from yetanotherconsolegameengine_tpu_torch.ops import kernels, mesh_bvh, trace
from yetanotherconsolegameengine_tpu_torch.render.renderer import \
    RaytraceRenderer
from yetanotherconsolegameengine_tpu_torch.scene.builders import SCENE_BUILDERS
from yetanotherconsolegameengine_tpu_torch.scene.mesh_scenes import \
    FORCED_SCENE_BUILDERS
from yetanotherconsolegameengine_tpu_torch.utils import profiling

torch.set_num_threads(1)

W, H = 16, 10
# A device object only: nothing is allocated on it here.
CUDA = torch.device("cuda", 0)
GRAPH_COUNTS = ("wavefront.graph_captures", "wavefront.graph_replays",
                "wavefront.eager_segments")
COLORED = {"wave.start", "wave.head0", "wave.head", "wave.tail",
           "shadow.start", "shadow.step", "shadow.end"}


def _rays(scene, frame):
    o, d = make_jittered_rays(None, W, H, frame,
                              params=ray_params(scene.default_pose, W, H,
                                                frame))
    px, py = pixel_grid(W, H, "cpu")
    seed = sampler.per_frame_seed(px, py, frame, DEFAULT_CONFIG.seed_salt)
    return o.reshape(-1, 3), d.reshape(-1, 3), seed.reshape(-1)


def _rerun(body):
    """A stand-in capture: records ``body``, and each replay runs it."""
    return SimpleNamespace(replay=body)


def _graph_counts():
    return tuple(profiling.COUNTS[k] for k in GRAPH_COUNTS)


def test_trace_all_on_the_cpu_never_captures():
    r = RaytraceRenderer(SCENE_BUILDERS["glass_gem"](), 8, 6, device="cpu")
    kernels.reset_launches()
    for _ in range(3):
        r.render()
    captures, replays, eager = _graph_counts()
    assert (captures, replays) == (0, 0)
    assert eager > 0
    assert trace._GRAPHS is None


def test_graphs_engage_from_the_second_call_on_one_scene_width_config(
        monkeypatch):
    monkeypatch.setattr(trace, "_GRAPHS", None)
    scene = SCENE_BUILDERS["glass"]()
    cfg = DEFAULT_CONFIG
    take = lambda sc=scene, P=64, c=cfg, dev=CUDA, impl="kernel": \
        trace._graphs_for(sc, P, c, dev, impl)
    assert take() is None                       # first call: eager
    g = take()
    assert isinstance(g, trace._Graphs) and take() is g
    assert take(P=65) is None and take(P=65) is not g     # new width
    assert take(c=dataclasses.replace(cfg, max_refractions=3)) is None
    other = dataclasses.replace(scene)          # same tables, new object
    assert take(sc=other) is None and take(sc=other) is trace._GRAPHS
    for refused in (dict(impl="plain"), dict(dev=torch.device("cpu")),
                    dict(sc=FORCED_SCENE_BUILDERS["cluster_forced"]())):
        take(), take()
        assert take(**refused) is None and trace._GRAPHS is None
    monkeypatch.setattr(trace, "WAVEFRONT_GRAPHS", False)
    take()
    assert take() is None and trace._GRAPHS is None


def test_a_replay_counts_what_its_capture_counted():
    def seg(st):
        kernels.LAUNCHES["bvh"] += 1
        mesh_bvh.STATS["sweeps"] += 1
        st["y"] = st["x"] * 2.0

    def capture(body):
        body()          # a capture runs the Python and launches nothing
        return SimpleNamespace(replay=lambda: replays.append(1))

    replays = []
    kernels.reset_launches()
    g = trace._Graphs(SCENE_BUILDERS["glass"](), None, capture)
    st = {"x": torch.ones(3)}
    g.run("t.seg", seg, st)
    assert (kernels.LAUNCHES["bvh"], mesh_bvh.STATS["sweeps"]) == (1, 1)
    assert _graph_counts() == (1, 0, 1)
    assert st["y"].tolist() == [2.0, 2.0, 2.0]
    home = st["y"]
    for n in (2, 3):
        st = {"x": st["x"]}
        g.run("t.seg", seg, st)
        assert st["y"] is home
        assert (kernels.LAUNCHES["bvh"], mesh_bvh.STATS["sweeps"]) == (n, n)
    assert _graph_counts() == (1, 2, 1) and len(replays) == 2


def test_a_replay_refuses_a_state_of_other_tensors():
    g = trace._Graphs(SCENE_BUILDERS["glass"](), None, _rerun)
    st = {"x": torch.ones(3)}
    g.run("t.seg", lambda s: s.update(y=s["x"] + 1.0), st)
    x = st["x"]
    x.fill_(4.0)
    st = {"x": x}
    g.run("t.seg", lambda s: s.update(y=s["x"] + 1.0), st)
    assert st["y"].tolist() == [5.0, 5.0, 5.0]
    with pytest.raises(RuntimeError, match="other tensors"):
        g.run("t.seg", lambda s: s.update(y=s["x"] + 1.0),
              {"x": torch.ones(3)})


@pytest.mark.parametrize("name,binary", [
    ("glass", False), ("glass", True), ("texture_test", False),
    ("glass_gem", False)])
def test_replayed_segments_equal_the_eager_frames_bit_for_bit(name, binary):
    scene = dataclasses.replace(SCENE_BUILDERS[name](),
                                binary_shadows=binary)
    g = trace._Graphs(scene, None, _rerun)
    kinds = []
    for frame in range(4):
        o, d, seed = _rays(scene, frame)
        kernels.reset_launches()
        want = trace._trace(scene, o, d, seed, DEFAULT_CONFIG, "plain", None)
        eager = (dict(profiling.SYNCS), mesh_bvh.STATS["sweeps"],
                 profiling.COUNTS["wavefront.shadow_sweeps"])
        kernels.reset_launches()
        got = trace._trace(scene, o, d, seed, DEFAULT_CONFIG, "plain", g)
        assert (dict(profiling.SYNCS), mesh_bvh.STATS["sweeps"],
                profiling.COUNTS["wavefront.shadow_sweeps"]) == eager
        kinds.append(_graph_counts())
        homes = {h.untyped_storage().data_ptr() for h in g.homes.values()}
        for f in dataclasses.fields(want):
            a, b = getattr(want, f.name), getattr(got, f.name)
            assert torch.equal(a, b), (frame, f.name)
            assert b.untyped_storage().data_ptr() not in homes
    want_kinds = ({"wave.start", "wave.head0", "wave.head", "wave.tail",
                   "shadow.binary"} if binary else COLORED)
    assert set(g.graphs) == want_kinds
    assert kinds[0][0] == len(want_kinds)
    for captures, replays, eager in kinds[1:]:
        assert (captures, eager) == (0, 0) and replays > 0
