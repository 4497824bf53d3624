"""The port's tracer (``utils/profiling.py``): spans, counters and sync
sites, their registry, the spans on the program's paths under a CPU
``torch.profiler``, and the benchmark's readers of them."""

import os
import re
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from yetanotherconsolegameengine_tpu_torch.engine.chexel import Framebuffer
from yetanotherconsolegameengine_tpu_torch.engine.entity import BaseEntity
from yetanotherconsolegameengine_tpu_torch.engine.raytrace_entity import (
    RaytraceComponent)
from yetanotherconsolegameengine_tpu_torch.engine.terminal import Terminal
from yetanotherconsolegameengine_tpu_torch.ops import (dda, kernels,
                                                       mesh_bvh, trace)
from yetanotherconsolegameengine_tpu_torch.render.renderer import \
    RaytraceRenderer
from yetanotherconsolegameengine_tpu_torch.scene.materials import Material
from yetanotherconsolegameengine_tpu_torch.scene.tables import SceneBuilder
from yetanotherconsolegameengine_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "yetanotherconsolegameengine_tpu_torch"


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _recording() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


def test_span_off_is_shared_and_records_nothing_while_counts_count():
    kernels.reset_launches()
    assert not _recording()
    assert profiling.span("tick") is profiling.span("frame.post")
    with profiling.span("tick"):
        with profiling.span("frame.post"):
            pass
    profiling.count("wavefront.shadow_sweeps", 3)
    got = profiling.sync("trace.round_live", int, torch.tensor(7))
    assert got == 7
    profiling.waited("entity.host_copy", 5_000)
    assert profiling.SPANS == {}
    assert not profiling.SYNC_NS
    assert profiling.COUNTS["wavefront.shadow_sweeps"] == 3
    assert profiling.SYNCS["trace.round_live"] == 1
    assert profiling.SYNCS["entity.host_copy"] == 1


def test_span_on_totals_self_time_nesting_and_ranges():
    kernels.reset_launches()
    with _cpu_profile() as prof:
        assert _recording()
        for _ in range(2):
            with profiling.span("render.call"):
                time.sleep(0.002)
                with profiling.span("render.prep"):
                    time.sleep(0.003)
                    profiling.sync("renderer.pose_upload", time.sleep, 0.001)
        profiling.waited("entity.host_copy", 5_000)
    calls, ns, self_ns = profiling.SPANS["render.call"]
    icalls, ins, iself = profiling.SPANS["render.prep"]
    assert (calls, icalls) == (2, 2)
    assert self_ns == ns - ins and iself == ins
    assert ns >= 2 * 6e6 and ins >= 2 * 4e6 and self_ns >= 2 * 2e6
    assert profiling.SYNCS["renderer.pose_upload"] == 2
    assert profiling.SYNC_NS["renderer.pose_upload"] >= 2 * 1e6
    assert profiling.SYNC_NS["entity.host_copy"] == 5_000
    events = prof.events()
    names = [ev.name for ev in events]
    assert names.count("render.call") == 2
    assert names.count("render.prep") == 2
    assert names.count("sync.renderer.pose_upload") == 2
    for ev in events:
        if ev.name == "render.prep":
            assert ev.cpu_parent.name == "render.call"
        if ev.name == "sync.renderer.pose_upload":
            assert ev.cpu_parent.name == "render.prep"
    assert not _recording()
    assert profiling.span("tick") is profiling.span("tick.hud")


def test_reset_clears_the_registry_and_zeroes_launches():
    launches = kernels.LAUNCHES
    assert profiling.TABLES["kernels.launches"] is launches
    assert profiling.TABLES["mesh_bvh.stats"] is mesh_bvh.STATS
    assert profiling.TABLES["dda.stats"] is dda.STATS
    launches["trace"] += 3
    mesh_bvh.STATS["sweeps"] += 2
    dda.STATS["rounds"] += 5
    profiling.count("wavefront.shadow_sweeps")
    profiling.sync("entity.copy_wait", lambda: None)
    with _cpu_profile():
        with profiling.span("tick"):
            profiling.sync("entity.copy_wait", lambda: None)
    kernels.reset_launches()
    assert kernels.LAUNCHES is launches
    assert launches == {"trace": 0, "post": 0, "clusters": 0, "bvh": 0,
                        "dda": 0, "prim": 0, "cluster_prep": 0,
                        "cluster_cull": 0, "cluster_resolve": 0}
    assert not mesh_bvh.STATS and not dda.STATS
    assert not profiling.SPANS and not profiling.COUNTS
    assert not profiling.SYNCS and not profiling.SYNC_NS


class _NoKeys:
    """A terminal input with no keys pressed."""

    def update(self):
        pass

    def try_get_key(self):
        return None

    def try_get_mouse(self):
        return None

    def is_key_down(self, key):
        return False


def _program(scene: str, w: int, h: int, batch: int):
    """What ``engine/program.py --size WxH --no-world --non-interactive
    --device cpu`` builds, its frames written to ``os.devnull``: (the
    terminal, its ray-trace component, the open descriptor)."""
    out_fd = os.open(os.devnull, os.O_WRONLY)
    term = Terminal(backend="ansi", interactive=False, out_fd=out_fd)
    term.renderer.console_size = lambda: (w, h + 1)
    term.renderer.remove_framebuffer(term.fb)
    term.fb = Framebuffer(w, h)
    term.renderer.add_framebuffer(term.fb)
    term.fixed_size = True
    entity = BaseEntity()
    rt = RaytraceComponent(term.fb, start_scene=scene, enable_world=False,
                           batch=batch, device="cpu")
    entity.add_component(rt)
    term.add_entity(entity)
    return term, rt, out_fd


@pytest.mark.parametrize("batch,ticks", [(1, 3), (2, 4)])
def test_cornell_ticks_record_each_span_once(batch, ticks):
    """The program's tick on a tiny Cornell box: each span once a tick, a
    call or a frame, the sync sites counted."""
    term, rt, out_fd = _program("cornell", 12, 6, batch)
    term.input = _NoKeys()
    dt = 1.0 / 30.0
    try:
        for _ in range(2 * batch):   # past the batched loop's cold start
            term.tick(time.perf_counter(), dt)
        kernels.reset_launches()
        f0 = rt.renderer.state.frame_idx
        with _cpu_profile() as prof:
            for _ in range(ticks):
                term.tick(time.perf_counter(), dt)
        frames = rt.renderer.state.frame_idx - f0
    finally:
        rt.close()
        os.close(out_fd)
    calls = frames // batch
    assert frames == ticks
    n = {k: v[0] for k, v in profiling.SPANS.items()}
    want = {"tick": ticks, "tick.input": ticks, "tick.hud": ticks,
            "component.update": ticks,
            # batch 1: the blit and the HUD text, apart
            "component.blit": 2 * ticks if batch == 1 else ticks,
            "render.call": calls, "render.prep": 2 * calls,
            "frame.trace": frames, "frame.post": 2 * frames,
            "present.compose": ticks, "present.encode": ticks,
            "present.write": ticks}
    for name, k in want.items():
        assert n[name] == k, name
    assert n["wavefront.shadow"] >= frames   # the plain trace on the CPU
    assert profiling.COUNTS["wavefront.shadow_sweeps"] >= n[
        "wavefront.shadow"]
    assert profiling.SYNCS["renderer.pose_upload"] == 4 * calls
    assert profiling.SYNCS["camera.world_up"] == calls
    assert sum(profiling.SYNCS.values()) > 0
    assert set(profiling.SYNC_NS) == set(profiling.SYNCS)
    assert set(n) <= set(profiling.SPAN_NAMES)
    ranges = {ev.name for ev in prof.events()}
    assert set(want) <= ranges
    # Inclusive time holds the spans inside it.
    assert profiling.SPANS["tick"][1] >= profiling.SPANS[
        "component.update"][1] >= profiling.SPANS["render.call"][1]


def _occluder_scene():
    """A floor lit from above through a glass sphere."""
    s = SceneBuilder("occluder")
    s.add_xz_rect(-4.0, 4.0, -4.0, 4.0, 0.0, Material.solid((0.8, 0.8, 0.8)))
    s.add_sphere((0.0, 1.5, 0.0), 0.5,
                 Material.glass(transmission=(0.9, 0.5, 0.5)))
    s.add_light((0.0, 3.0, 0.0), (1, 1, 1), 20.0)
    s.set_camera((0.0, 1.0, 3.0), fov=60.0)
    return s.build()


def test_shadow_loop_sweeps_twice_through_a_transparent_occluder():
    sc = _occluder_scene()
    cfg = RaytraceRenderer(sc, 4, 2, device="cpu").cfg
    so = torch.tensor([[0.0, 0.01, 0.0], [0.1, 0.01, 0.0],
                       [3.0, 0.01, 3.0]])
    to_l = torch.tensor([0.0, 3.0, 0.0]) - so
    dist = to_l.norm(dim=1)
    need = torch.ones(3, dtype=torch.bool)
    kernels.reset_launches()
    with _cpu_profile():
        tr, rays = trace.transmittance_to_lights(
            sc, so, to_l / dist[:, None], dist - 1e-4, need, cfg)
    assert cfg.max_refractions == 2
    assert profiling.COUNTS["wavefront.shadow_sweeps"] == 2
    assert profiling.SYNCS["trace.shadow_live"] == 2
    assert rays.tolist() == [2, 2, 1]   # through the glass; past it
    assert (tr[:2] < 1.0).all() and (tr[:2] > 0.0).all()
    assert tr[2].tolist() == [1.0, 1.0, 1.0]


def test_wavefront_frames_record_each_span_once_a_frame():
    r = RaytraceRenderer(_occluder_scene(), 8, 6, device="cpu")
    r.set_scene(r.scene, static=False)   # the torch wavefront
    r.set_camera((0.0, 2.5, 2.0), 0.0, -0.9)
    r.render()
    kernels.reset_launches()
    with _cpu_profile():
        for _ in range(2):
            r.render()
    n = {k: v[0] for k, v in profiling.SPANS.items()}
    assert (n["render.call"], n["render.prep"], n["frame.trace"],
            n["frame.post"]) == (2, 4, 2, 4)
    assert n["wavefront.shadow"] >= 2
    sweeps = profiling.COUNTS["wavefront.shadow_sweeps"]
    # A sweep follows each check that found a live shadow ray.
    assert 0 < sweeps <= profiling.SYNCS["trace.shadow_live"]
    assert profiling.SYNCS["trace.round_live"] >= 2
    assert profiling.SPANS["frame.trace"][1] >= profiling.SPANS[
        "wavefront.shadow"][1]


def test_shadow_span_encloses_a_range_wrapped_around_the_loop(monkeypatch):
    """A range a tool wraps around ``transmittance_to_lights`` (as
    ``benchmark/devtrace.py::patch_stages`` does) lies inside the
    ``wavefront.shadow`` span and holds the loop's operations itself."""
    from torch.autograd.profiler import record_function
    real = trace.transmittance_to_lights

    def staged(*a, **k):
        with record_function("shadow loop (torch)"):
            return real(*a, **k)
    monkeypatch.setattr(trace, "transmittance_to_lights", staged)
    r = RaytraceRenderer(_occluder_scene(), 8, 6, device="cpu")
    r.set_scene(r.scene, static=False)
    with _cpu_profile() as prof:
        r.render()
    stage = [ev for ev in prof.events() if ev.name == "shadow loop (torch)"]
    assert stage
    for ev in stage:
        assert ev.cpu_parent.name == "wavefront.shadow"
        assert any(c.name.startswith("aten::") for c in ev.cpu_children)


def test_a_span_leaves_its_kernels_to_a_stage_range_around_it():
    """A span opens a range of the operators' (function) scope, not a user
    range: a device trace gives a kernel the innermost user range open at
    its launch, so a span inside a range a tool wraps around a function
    (as ``benchmark/devtrace.py::patch_stages`` does) takes none of the
    range's kernels away from it."""
    from torch.autograd.profiler import record_function
    with _cpu_profile() as prof:
        with record_function("a stage"):
            with profiling.span("clusters.sweep"):
                torch.ones(3).add_(1.0)
    ev = {e.name: e for e in prof.events()}
    assert ev["clusters.sweep"].cpu_parent.name == "a stage"
    assert ev["aten::add_"].cpu_parent.name == "clusters.sweep"
    assert ev["clusters.sweep"].scope == ev["aten::add_"].scope
    assert ev["clusters.sweep"].scope != ev["a stage"].scope


READERS = {   # metric: (what it reads, per)
    "shell.compose_ms": ("present.compose", "ticks"),
    "shell.encode_ms": ("present.encode", "ticks"),
    "shell.blit_ms": ("component.blit", "ticks"),
    "render.prep_host_ms": ("render.prep", "frames"),
    "render.trace_host_ms": ("frame.trace", "frames"),
    "render.post_host_ms": ("frame.post", "frames"),
    "wavefront.shadow_host_ms": ("wavefront.shadow", "frames"),
    "wavefront.shadow_sweeps": ("counter", "frames"),
    "device.syncs_per_frame": ("syncs", "frames"),
    "device.sync_wait_ms": ("sync ns", "frames"),
    "clusters.host_ms": ("clusters.sweep", "frames"),
    "clusters.sweeps": ("counter", "frames"),
    "wavefront.prim_kernel_share": ("share", None),
    "clusters.kernel_share": ("share", None),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_metric_reader_reads_the_registry(name, monkeypatch):
    from benchmark import spec
    reader = spec.metric_reader(name)
    assert reader.read(SimpleNamespace(prof=None, spans=None,
                                       cell=None)) is None
    kernels.reset_launches()
    for span in profiling.SPAN_NAMES:
        profiling.SPANS[span] = [3, 7_000_000, 1_000_000]
    profiling.COUNTS["wavefront.shadow_sweeps"] = 30
    profiling.COUNTS["clusters.sweeps"] = 30
    profiling.COUNTS["wavefront.prim_kernel_sweeps"] = 30
    profiling.COUNTS["wavefront.prim_plain_sweeps"] = 10
    profiling.COUNTS["clusters.kernel_sweeps"] = 30
    profiling.COUNTS["clusters.plain_sweeps"] = 10
    profiling.SYNCS.update({"entity.copy_wait": 8, "trace.round_live": 16})
    profiling.SYNC_NS.update({"entity.copy_wait": 2_000_000,
                              "trace.round_live": 6_000_000})
    t = SimpleNamespace(prof=SimpleNamespace(ticks=4, frames=8), spans=None,
                        cell=None)
    what, per = READERS[name]
    want = {"counter": 30, "syncs": 24, "sync ns": 8.0}.get(what, 7.0)
    # A share is 100 x kernel sweeps over all sweeps, not a rate.
    want = 75.0 if what == "share" else want / (4 if per == "ticks" else 8)
    try:
        assert reader.read(t) == pytest.approx(want)
        assert reader.read(SimpleNamespace(
            prof=SimpleNamespace(ticks=0, frames=0), spans=None,
            cell=None)) is None
    finally:
        kernels.reset_launches()


def test_metric_readers_stay_silent_without_the_tracer(monkeypatch):
    """Against a program whose profiling module has no registry, each new
    reader returns None and does not raise."""
    import sys
    import types

    from benchmark import spec
    bare = types.ModuleType(profiling.__name__)
    monkeypatch.setitem(sys.modules, profiling.__name__, bare)
    t = SimpleNamespace(prof=SimpleNamespace(ticks=4, frames=8), spans=None,
                        cell=None)
    for name in READERS:
        assert spec.metric_reader(name).read(t) is None, name


DEVICE_READERS = {   # metric: the device-trace stage it reads
    "k3.device_ms": "K3 cluster sweeps",
    "k3.roofline_share": "K3 cluster sweeps",
    "clusters.torch_device_ms": "cluster sweep host side (torch)",
}


@pytest.mark.parametrize("name", sorted(DEVICE_READERS))
def test_device_trace_readers_read_their_stage(name, monkeypatch):
    """Each reads its stage's device ms over the profiled frames (K3's
    share: its frozen least time over them, whatever the program counts),
    and None without a profile, a frame or the stage."""
    import inspect

    from benchmark import devtrace, spec
    reader = spec.metric_reader(name)
    stage = DEVICE_READERS[name]
    assert stage in {label for _, label in devtrace.STAGES}

    def traced(stage_ms, frames=4):
        return SimpleNamespace(prof=SimpleNamespace(
            stage_ms=stage_ms, frames=frames, ops=[]), spans=None, cell=None)
    t = traced({stage: 6.0, "K1 post": 1.0, devtrace.OTHER: 9.0})
    if name == "k3.roofline_share":
        bound = devtrace.roofline(reader.LANE_TESTS * 40, reader.BYTES)
        assert bound > 0
        assert reader.read(t) == pytest.approx(100.0 * bound / 1.5)
        assert "yetanotherconsolegameengine_tpu_torch" not in \
            inspect.getsource(reader)
        kernels.reset_launches()
        try:
            profiling.COUNTS.update({"clusters.sweeps": 7,
                                     "clusters.rays": 10**6})
            profiling.SPANS["clusters.sweep"] = [7, 9_000_000, 1_000_000]
            assert reader.read(t) == pytest.approx(100.0 * bound / 1.5)
        finally:
            kernels.reset_launches()
        monkeypatch.setattr(reader, "LANE_TESTS", 2 * reader.LANE_TESTS)
        monkeypatch.setattr(reader, "BYTES", 2 * reader.BYTES)
        assert reader.read(t) == pytest.approx(200.0 * bound / 1.5)
    else:
        assert reader.read(t) == pytest.approx(1.5)
    assert reader.read(SimpleNamespace(prof=None, spans=None,
                                       cell=None)) is None
    assert reader.read(traced({"K1 post": 1.0})) is None
    assert reader.read(traced({stage: 6.0}, frames=0)) is None


def test_span_names_are_disjoint_from_the_benchmark_labels():
    from benchmark import devtrace
    stages = {label for _, label in devtrace.STAGES}
    bench = set(re.findall(r'"(bench\.[a-z_]+)"',
                           (ROOT / "benchmark" / "run.py").read_text()
                           + (ROOT / "benchmark" / "shell.py").read_text()))
    assert bench >= {"bench.render_call", "bench.compose_encode_write"}
    names = set(profiling.SPAN_NAMES)
    assert len(names) == len(profiling.SPAN_NAMES)
    assert not names & (stages | bench)
    assert not any(n.startswith("bench.") for n in names)
    assert not profiling.SYNC_PREFIX.startswith("bench.")
    # Every span the port opens is listed; every site is named once.
    src = "".join(p.read_text() for p in PORT.rglob("*.py"))
    opened = set(re.findall(r'profiling\.span\("([^"]+)"\)', src))
    assert opened == names
    sites = re.findall(r'profiling\.(?:sync|waited)\(\s*"([^"]+)"', src)
    assert len(sites) == len(set(sites))
    assert not {profiling.SYNC_PREFIX + s for s in sites} & (stages | bench)


def test_device_trace_writes_into_a_fresh_directory_by_default(tmp_path):
    dirs = []
    for _ in range(2):
        with profiling.device_trace() as d:
            torch.ones(4).sum()
        dirs.append(d)
        assert os.path.isfile(os.path.join(d, "trace.json"))
    assert dirs[0] != dirs[1]
    assert not any(d.rstrip("/").endswith("yacge_trace") for d in dirs)
    with profiling.device_trace(str(tmp_path)) as d:
        pass
    assert d == str(tmp_path) and (tmp_path / "trace.json").is_file()
