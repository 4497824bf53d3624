"""The ported slice as a whole on the CPU: the renderer against the JAX
package's goldens, the batched frame loop, explicit dispatch, and the
guard that the port runs without JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.golden_gen import FB_H, FB_W, FRAMES
from yetanotherconsolegameengine_tpu_torch.ops import cluster_kernel
from yetanotherconsolegameengine_tpu_torch.render.renderer import (
    RaytraceRenderer)
from yetanotherconsolegameengine_tpu_torch.scene.builders import SCENE_BUILDERS

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

_GOLDENS = os.path.join(os.path.dirname(__file__), "goldens.npz")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def goldens():
    return np.load(_GOLDENS)


@pytest.mark.parametrize("name", ["test", "cornell", "mirror_spheres",
                                  "primitives", "boxes", "glass",
                                  "glass_gem", "texture_test", "voxel_test"])
def test_renderer_matches_golden(goldens, name):
    r = RaytraceRenderer(SCENE_BUILDERS[name](), FB_W, FB_H, device="cpu")
    for _ in range(FRAMES):
        out = r.render()
    np.testing.assert_allclose(out.top_rgb.numpy(), goldens[f"{name}_top"],
                               atol=2e-3)
    np.testing.assert_allclose(out.bot_rgb.numpy(), goldens[f"{name}_bot"],
                               atol=2e-3)


def _island_surface_scene(tmp_path):
    """The golden's island (tests/golden_gen.py): 2x2x2 chunks, view
    distance 1, one update, seen from 10 above the spawn looking down."""
    from yetanotherconsolegameengine_tpu_torch.world.settings import (
        WorldConfig)
    from yetanotherconsolegameengine_tpu_torch.world.volume_scene import (
        build_minecraft_like)
    cfg = WorldConfig(chunks_x=2, chunks_y=2, chunks_z=2, view_distance=1)
    vs = build_minecraft_like(cfg, world_path=str(tmp_path / "w.vg"),
                              regenerate=True, device="cpu")
    try:
        vs.manager.ensure_all_loaded(vs.pos, timeout=60.0)
        sc = vs.update(1.0 / 30.0)
    finally:
        vs.manager.shutdown()
    pose = (float(vs.pos[0]), float(vs.pos[1]) + 10.0, float(vs.pos[2]),
            sc.defaults[3], -0.9, sc.defaults[5])
    return dataclasses.replace(sc, defaults=pose)


def _bf16_split(x):
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def _tpu_arithmetic_sweep(lens, ids, entry_t, gmat, rays, any_hit, qmask):
    """``trace_tiles_plain`` with the JAX kernel's ray-triangle arithmetic
    (ops/mesh_clusters.py:_trace_kernel there): each Woop dot product as
    the hi/lo bfloat16 passes g_hi*x_hi + g_hi*x_lo + g_lo*x_hi summed in
    float32, and t by a Newton-refined reciprocal. Its rounding decides
    which of two coplanar quads a ray through their shared vertex hits."""
    n_tiles, C = ids.shape
    kc = gmat.shape[2]
    r = rays.view(n_tiles, 256, 8)
    one = torch.ones_like(r[..., 0])
    o_hi, o_lo = _bf16_split(torch.stack([r[..., 0], r[..., 1], r[..., 2],
                                          one], -1))
    d_hi, d_lo = _bf16_split(torch.stack([r[..., 3], r[..., 4], r[..., 5],
                                          one * 0.0], -1))
    best_key = cluster_kernel.key_of(r[..., 7].contiguous(), qmask)
    best_t = torch.full((n_tiles, 256), cluster_kernel.NO_HIT_T)
    best_id = torch.full((n_tiles, 256), -1, dtype=torch.int32)
    inf = torch.tensor(float("inf"))
    for e in range(C):
        bound = torch.where(best_id >= 0, -inf, best_key) if any_hit \
            else best_key
        want = cluster_kernel.key_of(entry_t[:, e].contiguous(),
                                     qmask)[:, None] <= bound
        live = want.any(1) & (e < lens)   # entries ascend, bounds fall
        if not bool(live.any()):
            break
        g_hi, g_lo = _bf16_split(gmat[ids[:, e].long()])   # (n, 12, kc)

        def dot(f, x_hi, x_lo):
            rows = slice(4 * f, 4 * f + 4)
            return torch.bmm(torch.cat([x_hi, x_lo, x_hi], -1),
                             torch.cat([g_hi[:, rows], g_hi[:, rows],
                                        g_lo[:, rows]], 1))
        dw = dot(2, d_hi, d_lo)
        r0 = 1.0 / dw
        t = -dot(2, o_hi, o_lo) * (r0 * (2.0 - dw * r0))
        u = dot(0, o_hi, o_lo) + t * dot(0, d_hi, d_lo)
        v = dot(1, o_hi, o_lo) + t * dot(1, d_hi, d_lo)
        valid = ((torch.minimum(torch.minimum(u, v), 1.0 - u - v) >= -1e-3)
                 & (t > r[..., 6, None]) & live[:, None, None])
        key = torch.where(valid, cluster_kernel.key_of(t, qmask), inf)
        kmin = key.amin(-1)
        k = torch.where(key == kmin[..., None], torch.arange(kc), kc).amin(-1)
        better = kmin < best_key
        best_key = torch.where(better, kmin, best_key)
        best_t = torch.where(better, t.gather(-1, k[..., None])[..., 0],
                             best_t)
        best_id = torch.where(better, ids[:, e, None] * kc + k.int(),
                              best_id)
    return best_t.reshape(-1), best_id.reshape(-1), lens


def test_renderer_matches_island_surface_golden(goldens, tmp_path,
                                                monkeypatch):
    """The streamed island on its surface clusters (K3's path), 4 frames.
    The golden was rendered by the JAX kernel, whose bfloat16 hi/lo
    products reject one triangle at a shared vertex that exact float32
    accepts: with that arithmetic in the sweep the port holds the golden
    within 2e-3; with its own, the one pixel of frame 4 that it moves
    spreads through TAA and the a-trous passes to under 2% of the cells."""
    scene = _island_surface_scene(tmp_path)

    def frames():
        r = RaytraceRenderer(scene, FB_W, FB_H, device="cpu")
        for _ in range(FRAMES):
            out = r.render()
        return out.top_rgb.numpy(), out.bot_rgb.numpy()

    own = frames()
    monkeypatch.setattr(cluster_kernel, "trace_tiles_plain",
                        _tpu_arithmetic_sweep)
    emulated = frames()
    for got, half in zip(emulated, ("top", "bot")):
        np.testing.assert_allclose(got, goldens[f"island_surface_{half}"],
                                   atol=2e-3)
    off = np.maximum(*(np.abs(g - goldens[f"island_surface_{h}"]).max(-1)
                       for g, h in zip(own, ("top", "bot"))))
    assert 0.0 < (off > 2e-3).mean() < 0.02


def test_render_many_equals_repeated_render():
    scene = SCENE_BUILDERS["mirror_spheres"]()
    one = RaytraceRenderer(scene, 24, 16, device="cpu")
    many = RaytraceRenderer(scene, 24, 16, device="cpu")
    outs = [one.render() for _ in range(3)]
    grids, last = many.render_many(3, rgb=True)
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(grids[0][i].numpy(), out.fg_ansi.numpy())
        np.testing.assert_array_equal(grids[1][i].numpy(), out.bg_ansi.numpy())
    np.testing.assert_array_equal(last.top_rgb.numpy(),
                                  outs[-1].top_rgb.numpy())
    np.testing.assert_allclose(grids[2][-1].numpy() / 255.0,
                               outs[-1].top_rgb.numpy(), atol=1 / 510 + 1e-6)
    assert grids[3].shape == (3, 16, 24, 3)
    np.testing.assert_array_equal(many.state.history.numpy(),
                                  one.state.history.numpy())
    assert many.state.frame_idx == one.state.frame_idx == 3


def test_moving_camera_resets_history():
    r = RaytraceRenderer(SCENE_BUILDERS["cornell"](), 24, 16, device="cpu")
    poses = [((0.0, 1.0, 3.0 + 0.5 * i), 0.0, 0.0) for i in range(3)]
    grids, _ = r.render_many(3, poses=poses)
    assert grids[0].shape == (3, 16, 24)
    # The last pose moved, so its frame blends nothing: history == radiance.
    np.testing.assert_array_equal(r.state.history.numpy(),
                                  r.state.prev_gbuf[0:3].numpy())


def test_supersampled_frame():
    r = RaytraceRenderer(SCENE_BUILDERS["cornell"](), 12, 8, ss=2,
                         device="cpu")
    out = r.render()
    assert out.top_rgb.shape == (8, 12, 3)
    assert torch.isfinite(out.top_rgb).all()
    assert int(out.fg_ansi.min()) >= 16
    assert r.state.history.shape == (3, 32, 24)


def test_set_scene_resize_and_camera():
    r = RaytraceRenderer(SCENE_BUILDERS["cornell"](), 24, 16, device="cpu")
    r.render()
    r.set_scene(SCENE_BUILDERS["glass"]())
    assert r.state.frame_idx == 0 and r.cam_pos == [0.0, 1.2, 0.5]
    r.resize(20, 10)
    r.set_camera((0.0, 1.5, 1.0), 0.2, -0.1)
    out = r.render()
    assert out.fg_ansi.shape == (10, 20) and r.state.history.shape == (3, 20, 20)
    assert int(out.rays_traced) >= 20 * 20


def test_kernel_impl_needs_cuda():
    with pytest.raises(ValueError, match="CUDA"):
        RaytraceRenderer(SCENE_BUILDERS["cornell"](), 24, 16, device="cpu",
                         impl="kernel")
    with pytest.raises(ValueError):
        RaytraceRenderer(SCENE_BUILDERS["cornell"](), 24, 16, device="cpu",
                         impl="xla")


def test_port_runs_without_jax():
    """The card's machine has no JAX: importing the port (its voxel and
    streamed-world modules too) and rendering frames of a primitive, a
    mesh, a textured and a voxel scene must import neither jax nor the JAX
    package."""
    code = (
        "import sys\n"
        "from yetanotherconsolegameengine_tpu_torch.render.renderer import "
        "RaytraceRenderer\n"
        "from yetanotherconsolegameengine_tpu_torch.scene.builders import "
        "SCENE_BUILDERS\n"
        "from yetanotherconsolegameengine_tpu_torch.ops import dda\n"
        "from yetanotherconsolegameengine_tpu_torch.scene import "
        "voxel_scenes\n"
        "from yetanotherconsolegameengine_tpu_torch.world import surface, "
        "volume_scene\n"
        "for name in ('cornell', 'bunny', 'texture_test', 'voxel_cave'):\n"
        "    out = RaytraceRenderer(SCENE_BUILDERS[name](), 24, 16,"
        " device='cpu').render()\n"
        "    assert out.fg_ansi.shape == (16, 24)\n"
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
