"""Public functions of the JAX package whose port came last: the renderer's
``set_fov``, ``rgb_to_console16``, ``blue_noise`` and
``SceneBuilder.add_texture_file``, each against its JAX counterpart on
seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yetanotherconsolegameengine_tpu.core import camera as jcamera
from yetanotherconsolegameengine_tpu.core import sampler as jsampler
from yetanotherconsolegameengine_tpu.ops import ansi as jansi
from yetanotherconsolegameengine_tpu.render import renderer as jrenderer
from yetanotherconsolegameengine_tpu.scene import builders as jbuilders
from yetanotherconsolegameengine_tpu.scene import tables as jtables
from yetanotherconsolegameengine_tpu.scene.materials import Material as JMat
from yetanotherconsolegameengine_tpu_torch.core import camera, sampler
from yetanotherconsolegameengine_tpu_torch.ops import ansi
from yetanotherconsolegameengine_tpu_torch.render import renderer
from yetanotherconsolegameengine_tpu_torch.scene import builders, tables
from yetanotherconsolegameengine_tpu_torch.scene.materials import Material
from yetanotherconsolegameengine_tpu_torch.utils.png import write_png

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)


def test_set_fov_reaches_the_next_frames_camera(monkeypatch):
    seen = []
    real = renderer.stack_poses

    def spy(poses, fov_deg, device):
        cams = real(poses, fov_deg, device)
        seen.append(cams)
        return cams

    monkeypatch.setattr(renderer, "stack_poses", spy)
    r = renderer.RaytraceRenderer(builders.SCENE_BUILDERS["cornell"](), 16, 8,
                                  device="cpu")
    jr = jrenderer.RaytraceRenderer(jbuilders.SCENE_BUILDERS["cornell"](), 16,
                                    8)
    for fov in (35.0, 82.5):
        r.set_fov(fov)
        jr.set_fov(fov)
        r.render_many(2)
        want = jcamera.CameraPose.create(jr.cam_pos, jr.yaw, jr.pitch,
                                         jr.fov_deg)
        got = seen[-1]
        for f in ("pos", "yaw", "pitch", "fov_deg"):
            for k in range(2):
                np.testing.assert_array_equal(
                    getattr(got, f)[k].numpy(), np.asarray(getattr(want, f)),
                    err_msg=f)
        for k, frame in enumerate((1, 2)):
            pose = camera.CameraPose(pos=got.pos[k], yaw=got.yaw[k],
                                     pitch=got.pitch[k],
                                     fov_deg=got.fov_deg[k])
            _, d = camera.make_jittered_rays(pose, 16, 16, frame)
            _, jd = jcamera.make_jittered_rays(want, 16, 16,
                                               jnp.asarray(frame, jnp.int32))
            np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)


def test_rgb_to_console16_equals_jax():
    rgb = np.random.RandomState(7).uniform(-0.1, 1.1, (4096, 3)) \
        .astype(np.float32)
    got = ansi.rgb_to_console16(torch.from_numpy(rgb))
    want = np.asarray(jansi.rgb_to_console16(jnp.asarray(rgb)))
    assert got.dtype == torch.int32 and got.shape == (4096,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) == 16        # every palette entry is hit
    np.testing.assert_array_equal(ansi.PALETTE16, jansi.PALETTE16)


@pytest.mark.parametrize("channel", [0, 1])
def test_blue_noise_matches_jax(channel):
    rs = np.random.RandomState(11 + channel)
    px = rs.randint(0, 4096, (64, 48)).astype(np.uint32)
    py = rs.randint(0, 4096, (64, 48)).astype(np.uint32)
    for frame in range(4):
        got = sampler.blue_noise(torch.from_numpy(px.astype(np.int64)),
                                 torch.from_numpy(py.astype(np.int64)),
                                 torch.tensor(frame, dtype=torch.int32),
                                 channel)
        want = np.asarray(jsampler.blue_noise(
            jnp.asarray(px), jnp.asarray(py), jnp.asarray(frame, jnp.int32),
            channel))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
        assert (got >= 0).all() and (got < 1).all()


def test_add_texture_file_equals_jax(tmp_path):
    pytest.importorskip("PIL")
    img = np.random.RandomState(3).randint(0, 256, (6, 10, 3)) \
        .astype(np.uint8)
    path = str(tmp_path / "tex.png")
    write_png(path, img)
    ps, js = tables.SceneBuilder("tex"), jtables.SceneBuilder("tex")
    assert ps.add_texture_file(path) == js.add_texture_file(path) == 0
    ps.add_sphere((0, 0, 0), 1.0, Material.solid((1, 1, 1)))
    js.add_sphere((0, 0, 0), 1.0, JMat.solid((1, 1, 1)))
    got = ps.build().textures.numpy()
    want = np.asarray(js.build().textures)
    assert got.dtype == want.dtype == np.float32 and got.shape[0] == 1
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[0], (img / 255.0) ** 2.2, rtol=1e-6)
