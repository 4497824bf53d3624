"""The cluster-mesh slice as a whole on the CPU: the plain renderer against
the JAX package's goldens of the forced cluster scenes, and the lane-order
and compaction equalities of the mesh wavefront (tests/test_surface.py:247
holds the JAX package to the same)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.golden_gen import FB_H, FB_W, FRAMES
from yetanotherconsolegameengine_tpu_torch.config import DEFAULT_CONFIG
from yetanotherconsolegameengine_tpu_torch.ops import kernels, trace
from yetanotherconsolegameengine_tpu_torch.ops.mesh_clusters import (
    build_clusters)
from yetanotherconsolegameengine_tpu_torch.render.renderer import (
    RaytraceRenderer)
from yetanotherconsolegameengine_tpu_torch.scene.materials import Material
from yetanotherconsolegameengine_tpu_torch.scene.mesh_loader import (
    make_icosphere, transform_mesh)
from yetanotherconsolegameengine_tpu_torch.scene.mesh_scenes import (
    FORCED_SCENE_BUILDERS)
from yetanotherconsolegameengine_tpu_torch.scene.tables import (
    SceneBuilder, SceneData)

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

_GOLDENS = os.path.join(os.path.dirname(__file__), "goldens.npz")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["cluster_forced", "fine_forced"])
def test_plain_renderer_matches_cluster_goldens(name):
    goldens = np.load(_GOLDENS)
    before = kernels.LAUNCHES["clusters"]
    r = RaytraceRenderer(FORCED_SCENE_BUILDERS[name](), FB_W, FB_H,
                         device="cpu")
    assert isinstance(r.packed, SceneData)   # never the trace kernel's tables
    for _ in range(FRAMES):
        out = r.render()
    assert kernels.LAUNCHES["clusters"] == before
    np.testing.assert_allclose(out.top_rgb.numpy(), goldens[f"{name}_top"],
                               atol=2e-3)
    np.testing.assert_allclose(out.bot_rgb.numpy(), goldens[f"{name}_bot"],
                               atol=2e-3)


def _two_light_scene() -> SceneData:
    """cluster_forced with a second light, so shadows are light-major."""
    s = SceneBuilder("two_lights")
    s.add_xz_rect(-6.0, 6.0, -6.0, 3.0, 0.0,
                  Material.checker((0.8, 0.8, 0.8), (0.2, 0.2, 0.2), 0.8))
    s.add_light((2.0, 4.0, 2.0), (1.0, 1.0, 1.0), 60.0)
    s.add_light((-3.0, 3.0, -1.0), (0.8, 0.9, 1.0), 40.0)
    s.add_sphere((1.6, 0.6, -2.0), 0.6,
                 Material.solid((0.95, 0.95, 0.95), reflectivity=1.0))
    s.add_sphere((-1.5, 0.5, -1.2), 0.5, Material.glass())
    tris = transform_mesh(make_icosphere(3), scale=1.4,
                          translate=(0.0, 0.9, -2.5))
    s.add_mesh_triangles(tris, Material.solid((0.9, 0.85, 0.8)))
    mats = np.full(len(tris), s._mesh_tris[-1][1], np.int32)
    s.set_camera((0.0, 1.2, 1.0), fov=60.0)
    return s.build(clusters=dict(mesh_clusters=build_clusters(
        tris[:, 0], tris[:, 1], tris[:, 2], mats)))


def _frame(scene, cfg=DEFAULT_CONFIG, w=32, h=20):
    out = RaytraceRenderer(scene, w, h, cfg=cfg, device="cpu").render()
    return out.top_rgb.numpy(), out.bot_rgb.numpy(), int(out.rays_traced)


def _assert_same_frame(a, b):
    np.testing.assert_allclose(a[0], b[0], atol=1e-5)
    np.testing.assert_allclose(a[1], b[1], atol=1e-5)
    assert a[2] == b[2]


def test_compacted_wavefront_matches_uncompacted(monkeypatch):
    """Rounds after the first run on the gathered active lanes; the frame
    equals the uncompacted loop's (per-lane arithmetic is independent of
    the other lanes)."""
    scene = _two_light_scene()
    calls = []
    real = trace._compact
    monkeypatch.setattr(trace, "_compact",
                        lambda *a: calls.append(1) or real(*a))
    compacted = _frame(scene)
    assert len(calls) >= 3          # rounds 1, 2, ... each gathered
    monkeypatch.setattr(trace, "WAVEFRONT_COMPACTION", False)
    _assert_same_frame(compacted, _frame(scene))


def test_lmajor_shadows_match_ray_major():
    scene = _two_light_scene()
    assert scene.lights.mask.sum() == 2
    _assert_same_frame(
        _frame(scene),
        _frame(scene, dataclasses.replace(DEFAULT_CONFIG,
                                          lmajor_shadow=False)))


def test_block_lane_order_matches_row_order():
    """16x16 pixel-block lanes with dead padding rows (20 cell rows -> 40
    pixel rows -> 48): same image, and the dead lanes are not counted."""
    scene = FORCED_SCENE_BUILDERS["fine_forced"]()
    _assert_same_frame(
        _frame(scene),
        _frame(scene, dataclasses.replace(DEFAULT_CONFIG,
                                          block_order_primary=False)))


def test_mesh_scene_renders_without_jax():
    """Building and rendering a cluster-mesh scene imports neither jax nor
    the JAX package (the card's machine has neither)."""
    code = (
        "import sys\n"
        "from yetanotherconsolegameengine_tpu_torch.render.renderer import "
        "RaytraceRenderer\n"
        "from yetanotherconsolegameengine_tpu_torch.scene.mesh_scenes import "
        "FORCED_SCENE_BUILDERS\n"
        "r = RaytraceRenderer(FORCED_SCENE_BUILDERS['fine_forced'](), 16, 8,"
        " device='cpu')\n"
        "out = r.render()\n"
        "assert out.fg_ansi.shape == (8, 16) and int(out.rays_traced) > 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'yetanotherconsolegameengine_tpu' or "
        "m.startswith('yetanotherconsolegameengine_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
