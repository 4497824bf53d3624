"""The port's texture and surface code against the JAX package's: every
intersector's u, v, ``sample_albedo`` for all four procedural kinds, the
video-texture scene and its per-frame refresh, and routing by
``trace_kernel.scene_fits``."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yetanotherconsolegameengine_tpu.ops import intersect as jintersect
from yetanotherconsolegameengine_tpu.scene import builders as jbuilders
from yetanotherconsolegameengine_tpu.scene import materials as jmaterials
from yetanotherconsolegameengine_tpu_torch.ops import intersect, trace_kernel
from yetanotherconsolegameengine_tpu_torch.render.renderer import (
    RaytraceRenderer)
from yetanotherconsolegameengine_tpu_torch.scene import builders, materials
from yetanotherconsolegameengine_tpu_torch.scene import tables
from yetanotherconsolegameengine_tpu_torch.video import textures as vidtex
from tests.test_torch_intersect import CASES, _rays
from tests.test_torch_scene import flatten_jax_scene

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("table,scene", CASES)
def test_intersector_uv_matches_jax(table, scene):
    """u, v of each type's winner within 1e-6 where it hit (zeros for
    spheres, cylinders, disks and planes)."""
    jsc = jbuilders.SCENE_BUILDERS[scene]()
    psc = builders.SCENE_BUILDERS[scene]()
    o, d, tmin, tmax = _rays(sum(map(ord, table)))
    want = getattr(jintersect, f"intersect_{table}")(
        getattr(jsc, table), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax))
    got = getattr(intersect, f"intersect_{table}")(
        getattr(psc, table), torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(tmin), torch.from_numpy(tmax))
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert hit.sum() > 20
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[hit],
                                   np.asarray(getattr(want, f))[hit],
                                   rtol=0, atol=1e-6, err_msg=f)
    if table in ("spheres", "cylinders", "disks", "planes"):
        assert not got.u.any() and not got.v.any()


def _surface_inputs(seed, procs, n=4096):
    """Per-pixel material records of random procs, hit points spanning
    negative and large cells, UVs beyond [0, 1], and a two-texture bank."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.uniform(0.0, 1.0, s).astype(np.float32)
    rec = dict(albedo=f(n, 3), specular=f(n), reflectivity=f(n),
               emission=f(n, 3), transparency=f(n), ior=1.0 + f(n),
               transmission=f(n, 3),
               proc=rs.choice(procs, n).astype(np.int32), albedo2=f(n, 3),
               proc_scale=(0.2 + 2.0 * f(n)),
               tex_id=rs.randint(-1, 2, n).astype(np.int32),
               tex_weight=(1.4 * f(n) - 0.2),
               uv_scale=np.where(f(n) < 0.1, 0.0, 3.0 * f(n))
               .astype(np.float32))
    pos = rs.uniform(-40.0, 40.0, (n, 3)).astype(np.float32)
    pos[:8] = np.float32([[3e4, -2e4, 1e4]]) * (1 + np.arange(8)[:, None])
    uv = rs.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    tint = pos + rs.uniform(-1e-3, 1e-3, (n, 3)).astype(np.float32)
    bank = rs.uniform(0.0, 1.0, (2, 9, 13, 3)).astype(np.float32)
    return rec, pos, uv, tint, bank


@pytest.mark.parametrize("proc", ["solid", "checker", "texture", "cell_tint",
                                  "mixed"])
@pytest.mark.parametrize("with_bank", [True, False])
def test_sample_albedo_matches_jax(proc, with_bank):
    """Checker, per-cell tint (the int32 hash with wrapping multiplies,
    arithmetic shifts and Python's %), and bilinear texture sampling with
    UV wrap, V flip, tex_id -1, a zero uv_scale and clipped weights, within
    1e-6."""
    procs = {"solid": [0], "checker": [1], "texture": [2], "cell_tint": [3],
             "mixed": [0, 1, 2, 3]}[proc]
    rec, pos, uv, tint, bank = _surface_inputs(len(proc), procs)
    jmat = jmaterials.MaterialTable(**{k: jnp.asarray(v)
                                       for k, v in rec.items()})
    pmat = materials.MaterialTable(**{k: torch.from_numpy(v)
                                      for k, v in rec.items()})
    want = jmaterials.sample_albedo(
        jmat, jnp.asarray(pos), jnp.asarray(uv),
        jnp.asarray(bank) if with_bank else None, tint_pos=jnp.asarray(tint))
    got = materials.sample_albedo(
        pmat, torch.from_numpy(pos), torch.from_numpy(uv),
        torch.from_numpy(bank) if with_bank else None,
        tint_pos=torch.from_numpy(tint))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    if proc == "cell_tint":
        alb = rec["albedo"]
        ratio = (got.numpy() / np.maximum(alb, 1e-3))[(alb > 0.1)
                                                      & (alb < 0.8)]
        np.testing.assert_allclose(np.unique(np.round(ratio, 3)),
                                   [0.84, 0.92, 1.0, 1.08, 1.16])


def test_bilinear_sampling_wraps_and_flips_v():
    """u wraps with period 1; v = 0 is the image's last row."""
    bank = torch.arange(2 * 3 * 4 * 3, dtype=torch.float32).reshape(2, 3, 4, 3)
    tid = torch.tensor([1, 1, 1, 0])
    u = torch.tensor([0.0, 1.0, 2.0, 0.0])
    v = torch.tensor([0.0, 0.0, 1.0, 0.5])
    got = materials._sample_bilinear(bank, tid, u, v)
    np.testing.assert_array_equal(got[0].numpy(), bank[1, 2, 0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), bank[1, 2, 0].numpy())
    np.testing.assert_array_equal(got[2].numpy(), bank[1, 2, 0].numpy())
    np.testing.assert_array_equal(got[3].numpy(), bank[0, 1, 0].numpy())


def test_video_texture_scene_equals_jax(monkeypatch):
    """With the clock held still, the port's video_texture scene equals the
    JAX one (its first reader frame included), and carries across."""
    monkeypatch.setattr(time, "monotonic", lambda: 100.0)
    jsc = jbuilders.SCENE_BUILDERS["video_texture"]()
    psc = builders.SCENE_BUILDERS["video_texture"]()
    flat = flatten_jax_scene(jsc)
    mine = psc.to_numpy()
    assert sorted(mine) == sorted(flat)
    for k in mine:
        np.testing.assert_array_equal(mine[k], flat[k], err_msg=k)
    assert psc.has_dynamic_textures and psc.textures.shape == (1, 72, 128, 3)
    (tid, reader), = vidtex.readers_for("video_texture")
    assert tid == 0 and reader.width == 128
    carried = tables.scene_from_numpy(flat)
    assert carried.has_dynamic_textures
    np.testing.assert_array_equal(carried.textures.numpy(), flat["textures"])


class _StepReader:
    """A reader whose frame is a solid gray level that grows per poll."""

    width, height = 8, 4

    def __init__(self):
        self.polls = 0

    def try_get_frame(self):
        self.polls += 1
        return np.full((self.height, self.width, 3), 40 * self.polls,
                       np.uint8)


def test_video_texture_slot_refreshes_per_batch_and_resets_taa():
    s = tables.SceneBuilder("video_step")
    reader = _StepReader()
    tid = s.add_video_texture(reader)
    s.add_box((-0.8, -0.45, -2.5), (0.8, 0.45, -1.7), materials.Material(
        proc=materials.PROC_TEXTURE, tex_id=tid))
    s.add_light((0.0, 2.0, 0.0), (1, 1, 1), 10.0)
    s.set_camera((0.0, 0.0, 0.5))
    scene = s.build()
    r = RaytraceRenderer(scene, 12, 8, device="cpu")
    assert r.packed is r.scene
    assert r.scene.textures is not scene.textures
    r.render_many(2)
    assert reader.polls == 2
    np.testing.assert_allclose(r.scene.textures[0].numpy(),
                               (80 / 255.0) ** 2, rtol=1e-6)
    np.testing.assert_allclose(scene.textures[0].numpy(), (40 / 255.0) ** 2,
                               rtol=1e-6)
    # A live texture blends no history: every frame's history is its
    # radiance.
    np.testing.assert_array_equal(r.state.history.numpy(),
                                  r.state.prev_gbuf[0:3].numpy())
    vidtex.unregister_scene("video_step")


def test_scene_fits_routes_like_jax():
    """Primitive scenes with solid and checker surfaces take the trace
    kernel; meshes, textures, per-cell tint and a table too large for a
    block's shared memory take the wavefront."""
    fits = trace_kernel.scene_fits
    for name in ("cornell", "glass", "demo_random", "primitives"):
        assert fits(builders.SCENE_BUILDERS[name]()), name
    for name in ("bunny", "glass_gem", "texture_test", "video_texture",
                 "museum"):
        assert not fits(builders.SCENE_BUILDERS[name]()), name
    s = tables.SceneBuilder("tint")
    s.add_sphere((0, 0, -3), 1.0, materials.Material(
        proc=materials.PROC_CELL_TINT))
    assert not fits(s.build())
    s = tables.SceneBuilder("big")
    for i in range(12000):
        s.add_sphere((i * 0.01, 0.0, -5.0), 0.01, materials.Material())
    big = s.build()
    n = trace_kernel.table_len(big)
    assert n == 12000 * 5 + 18 + 10   # one material: the default row
    assert not fits(big)
    cornell = builders.SCENE_BUILDERS["cornell"]()
    packed = trace_kernel.pack_scene(cornell)
    assert trace_kernel.table_len(cornell) == packed.table.numel()


def test_renderer_routes_by_scene_fits():
    for name, kernel in (("demo_random", True), ("texture_test", False),
                         ("glass_gem", False)):
        r = RaytraceRenderer(builders.SCENE_BUILDERS[name](), 8, 4,
                             device="cpu")
        assert isinstance(r.packed, trace_kernel.PackedScene) == kernel, name
        out = r.render()
        assert torch.isfinite(out.top_rgb).all()


def test_wavefront_frame_equals_the_kernels_plain_version():
    """A scene that fits gives the same G-buffer through the wavefront
    frame as through the trace kernel's plain version, so routing changes
    nothing but where a scene runs."""
    from yetanotherconsolegameengine_tpu_torch.config import DEFAULT_CONFIG
    from yetanotherconsolegameengine_tpu_torch.core.camera import ray_params
    from yetanotherconsolegameengine_tpu_torch.render.renderer import (
        trace_wavefront_planes)
    scene = builders.SCENE_BUILDERS["mirror_spheres"]()
    params = ray_params(scene.default_pose, 16, 12, 3)
    a = trace_wavefront_planes(scene, params, 3, 16, 12, DEFAULT_CONFIG)
    b = trace_kernel.trace_planes_plain(scene, params, 3, 16, 12,
                                        DEFAULT_CONFIG)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
