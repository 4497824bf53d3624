"""The ported slice as a whole on the CPU: the renderer against the JAX
package's goldens, the batched frame loop, explicit dispatch, and the
guard that the port runs without JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.golden_gen import FB_H, FB_W, FRAMES
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
                                  "glass_gem", "texture_test"])
def test_renderer_matches_golden(goldens, name):
    r = RaytraceRenderer(SCENE_BUILDERS[name](), FB_W, FB_H, device="cpu")
    for _ in range(FRAMES):
        out = r.render()
    np.testing.assert_allclose(out.top_rgb.numpy(), goldens[f"{name}_top"],
                               atol=2e-3)
    np.testing.assert_allclose(out.bot_rgb.numpy(), goldens[f"{name}_bot"],
                               atol=2e-3)


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
    """The card's machine has no JAX: importing the port and rendering
    frames of a primitive, a mesh and a textured scene must import neither
    jax nor the JAX package."""
    code = (
        "import sys\n"
        "from yetanotherconsolegameengine_tpu_torch.render.renderer import "
        "RaytraceRenderer\n"
        "from yetanotherconsolegameengine_tpu_torch.scene.builders import "
        "SCENE_BUILDERS\n"
        "for name in ('cornell', 'bunny', 'texture_test'):\n"
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
