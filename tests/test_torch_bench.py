"""The port's measurement entry points (``bench_suite``, ``bench``) on the
CPU at 16x8 cells: each row function prints one JSON line with the JAX
suite's keys (``pallas`` replaced by ``kernels``, plus the ms columns),
its metric string in the JAX format and the frame's own ray count; the
row filter; and no row without a card unless the CPU is asked for."""

import json
import os
import re

import pytest
import torch

from yetanotherconsolegameengine_tpu_torch import bench, bench_suite
from yetanotherconsolegameengine_tpu_torch.render.renderer import (
    RaytraceRenderer)
from yetanotherconsolegameengine_tpu_torch.scene.builders import SCENE_BUILDERS
from yetanotherconsolegameengine_tpu_torch.scene.showcase_scenes import (
    build_spinning_mesh)
from yetanotherconsolegameengine_tpu_torch.world.settings import WorldConfig
from yetanotherconsolegameengine_tpu_torch.world.volume_scene import (
    build_minecraft_like)

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

W, H = 16, 8
# The JAX suite's row keys (bench_suite.py:90-97, 121-125, 152-156 and
# 287-292 of the JAX repository), without "pallas".
SCENE_KEYS = {"metric", "fps", "mrays_per_s", "interactive_fps",
              "batched_interactive_fps_k8"}
DYN_KEYS = {"metric", "interactive_fps", "fps", "mrays_per_s",
            "batched_interactive_fps_k8"}
VOLUME_KEYS = {"metric", "interactive_fps", "batched_interactive_fps_k8"}
ORBIT_KEYS = {"metric", "fps", "mrays_per_s"}
PORT_KEYS = {"kernels", "ms_per_frame", "host_ms_per_frame"}


def _row(capsys, returned) -> dict:
    """The one line a row printed, parsed, equal to what it returned."""
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    row = json.loads(lines[0])
    assert row == returned
    return row


def _rays(row, label) -> int:
    m = re.fullmatch(rf"{re.escape(label)} @{W}x{H} \((\d+) rays/frame\)",
                     row["metric"])
    assert m, row["metric"]
    return int(m.group(1))


def _positive(row, keys):
    for k in keys:
        assert isinstance(row[k], float) and row[k] > 0, (k, row[k])


def test_bench_scene_row(capsys):
    row = _row(capsys, bench_suite.bench_scene(
        "Cornell Box", SCENE_BUILDERS["cornell"](), W, H, batch=2,
        n_batches=1, n=2, k=2, device="cpu"))
    assert set(row) == SCENE_KEYS | PORT_KEYS
    _positive(row, SCENE_KEYS - {"metric"} | PORT_KEYS - {"kernels"})
    assert row["kernels"] == []             # no kernel runs on the CPU
    # The warm-up batch's last frame: a fresh renderer's second frame.
    _, out = RaytraceRenderer(SCENE_BUILDERS["cornell"](), W, H,
                              device="cpu").render_many(2)
    assert _rays(row, "Cornell Box") == int(out.rays_traced) > 0
    assert row["fps"] == pytest.approx(1e3 / row["ms_per_frame"])
    assert row["mrays_per_s"] == pytest.approx(
        _rays(row, "Cornell Box") * row["fps"] / 1e6)


def test_bench_dynamic_spinning_mesh_row(capsys):
    dyn = build_spinning_mesh()
    row = _row(capsys, bench_suite.bench_dynamic(
        "Spinning mesh", dyn.at_time, W, H, n=1, dyn=dyn, batch=1,
        n_batches=1, k=1, device="cpu"))
    assert set(row) == DYN_KEYS | PORT_KEYS
    _positive(row, DYN_KEYS - {"metric"} | PORT_KEYS - {"kernels"})
    assert _rays(row, "Spinning mesh") > 0 and row["kernels"] == []
    # 1 sustained warm-up frame, 1 timed and 9 pipelined batches of 1.
    assert dyn.t == pytest.approx(11 / 30.0)


def test_bench_island_rows(capsys, tmp_path):
    vs = build_minecraft_like(
        WorldConfig(chunks_x=2, chunks_y=2, chunks_z=2, view_distance=1),
        world_path=str(tmp_path / "w.vg"), device="cpu")
    try:
        vs.manager.ensure_all_loaded(vs.pos)
        vs.update(1.0 / 30.0)
        row = _row(capsys, bench_suite.bench_dynamic(
            "Island", lambda t: vs.update(1.0 / 30.0), W, H, n=2, volume=vs,
            k=2, device="cpu"))
        assert set(row) == VOLUME_KEYS | PORT_KEYS
        _positive(row, VOLUME_KEYS - {"metric"})
        assert row["ms_per_frame"] is None and row["host_ms_per_frame"] is None
        assert _rays(row, "Island") > 0

        row = _row(capsys, bench_suite.bench_island_orbit(
            vs, "Orbit", n_frames=3, fb_w=W, fb_h=H, device="cpu"))
        assert set(row) == ORBIT_KEYS | PORT_KEYS
        _positive(row, ORBIT_KEYS - {"metric"} | PORT_KEYS - {"kernels"})
        # The warm-up's last frame: the orbit's third pose on a fresh
        # renderer of the same scene.
        r = RaytraceRenderer(vs.update(1.0 / 30.0), W, H, device="cpu")
        eye = vs.pos.copy()
        eye[1] += 6.0
        _, out = r.render_many(3, poses=[
            (eye, 2 * 3.141592653589793 * i / 64, -0.35) for i in range(3)])
        assert _rays(row, "Orbit") == int(out.rays_traced)
    finally:
        vs.manager.shutdown()


def test_bench_lbvh_rebuild_row(capsys):
    row = _row(capsys, bench_suite.bench_lbvh_rebuild(device="cpu", n=2))
    assert set(row) == {"metric", "ms", "mtris_per_s", "host_ms"}
    assert row["metric"] == "on-device LBVH rebuild (3840 tris)"
    _positive(row, ("ms", "mtris_per_s", "host_ms"))


def test_bench_line():
    res = bench.run(W, H, batch=2, n_batches=1, device="cpu")
    assert set(res) == {"metric", "value", "unit", "vs_baseline"}
    assert res["unit"] == "Mray/s" and res["value"] > 0
    assert res["vs_baseline"] == pytest.approx(res["value"] / 500.0)
    assert re.fullmatch(r"Mrays/s, torch on the CPU, Cornell Box @16x8 cells "
                        r"\(16x16 px, \d+ rays/frame, [0-9.]+ fps\)",
                        res["metric"]), res["metric"]


@pytest.fixture
def recorded(monkeypatch):
    """The row functions replaced by recorders of the rows main runs."""
    calls = []
    monkeypatch.setattr(bench_suite, "bench_scene",
                        lambda name, *a, **kw: calls.append(name))
    monkeypatch.setattr(bench_suite, "bench_lbvh_rebuild",
                        lambda **kw: calls.append("lbvh"))
    return calls


def test_main_runs_the_named_rows_in_table_order(recorded, capsys):
    bench_suite.main(["lbvh", "cornell"], device="cpu")
    assert recorded == ["Cornell Box", "lbvh"]
    assert json.loads(capsys.readouterr().out.splitlines()[0]) == {
        "card": "cpu"}
    assert bench_suite.ROWS[0] == "cornell"
    assert bench_suite.ROWS[-1] == "lbvh" and len(bench_suite.ROWS) == 14


def test_main_refuses_an_unknown_row_before_any_row(recorded, capsys):
    with pytest.raises(ValueError, match="nope"):
        bench_suite.main(["cornell", "nope"], device="cpu")
    assert recorded == [] and capsys.readouterr().out == ""


def test_refuses_to_run_without_a_card(monkeypatch, recorded, capsys,
                                       tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench_suite.main(["cornell"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench.run(W, H, batch=2, n_batches=1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench_suite.bench_island_orbit(None, "Orbit")
    assert recorded == [] and capsys.readouterr().out == ""
    assert not os.listdir(tmp_path)
