"""The port's scene entities and dynamic scenes against the JAX package's:
every entity's patched table equal at several times, the exhibit ring's
and the spinning mesh's tables, the spun vertices and their LBVH, the
batched dynamic frame loop equal to per-frame updates, and one whole
spinning_mesh frame against one jitted JAX ``frame_step``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_lbvh import assert_lbvh_equal, torch_lbvh
from tests.test_torch_scene import _assert_same, flatten_jax_scene
from yetanotherconsolegameengine_tpu.ops import lbvh as jlbvh
from yetanotherconsolegameengine_tpu.scene import builders as jbuilders
from yetanotherconsolegameengine_tpu.scene import entities as jentities
from yetanotherconsolegameengine_tpu.scene import showcase_scenes as jshow
from yetanotherconsolegameengine_tpu_torch.render.renderer import (
    RaytraceRenderer)
from yetanotherconsolegameengine_tpu_torch.scene import builders, entities
from yetanotherconsolegameengine_tpu_torch.scene import showcase_scenes

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

TIMES = (0.0, 0.37, 1.0, 1.3, 2.0, 7.25)
MESH_POS = ("mesh.bmin", "mesh.bmax", "mesh.a", "mesh.e1", "mesh.e2")

ENTITIES = {
    "bobbing": ("test", lambda m: m.BobbingSphereEntity(
        index=0, base_center=(-1.2, 0.9, -2.2), amplitude=0.5,
        freq_hz=0.25)),
    "orbiting": ("test", lambda m: m.OrbitingLightEntity(
        index=0, pivot=(0.3, 0.0, -1.0), radius=2.0, height=3.0,
        period_s=4.0)),
    "pulsing": ("test", lambda m: m.PulsingLightEntity(
        index=0, base_intensity=100.0, depth=0.5, freq_hz=0.25)),
    "uv_wobble": ("texture_test", lambda m: m.UVWobbleEntity(
        mat_id=1, base_scale=2.0, depth=0.5, freq_hz=0.25)),
}


@pytest.mark.parametrize("kind", sorted(ENTITIES))
def test_entity_patch_equals_jax(kind):
    """The patched scene equals the JAX entity's, table for table, at
    every time: the same host math, rounded to float32 once."""
    scene_name, make = ENTITIES[kind]
    jsc = jbuilders.SCENE_BUILDERS[scene_name]()
    psc = builders.SCENE_BUILDERS[scene_name]()
    jent, pent = make(jentities), make(entities)
    base = {k: v.copy() for k, v in psc.to_numpy().items()}
    for t in TIMES:
        got = pent.apply(psc, t).to_numpy()
        _assert_same(got, flatten_jax_scene(jent.apply(jsc, t)))
    # The base scene's tensors are never written (at_time stays pure).
    _assert_same(psc.to_numpy(), base)


def test_entity_rows_have_their_values():
    """tests/test_entities.py's closed forms, on the port."""
    sc = builders.SCENE_BUILDERS["test"]()
    s1 = ENTITIES["bobbing"][1](entities).apply(sc, 1.0)
    np.testing.assert_allclose(s1.spheres.center[0].numpy(),
                               [-1.2, 1.4, -2.2], atol=1e-6)
    assert torch.equal(s1.spheres.center[1:], sc.spheres.center[1:])
    orb = entities.OrbitingLightEntity(index=0, pivot=(0, 0, 0), radius=2.0,
                                       height=3.0, period_s=4.0)
    np.testing.assert_allclose(orb.apply(sc, 1.0).lights.pos[0].numpy(),
                               [0.0, 3.0, 2.0], atol=1e-6)
    s2 = ENTITIES["pulsing"][1](entities).apply(sc, 1.0)
    assert abs(float(s2.lights.intensity[0]) - 150.0) <= 1e-4


@pytest.mark.parametrize("t", [0.0, 1.3, 2.0])
def test_exhibit_ring_tables_equal_jax(t):
    jdyn, pdyn = jshow.build_exhibit_ring(), showcase_scenes.build_exhibit_ring()
    assert [type(e).__name__ for e in pdyn.entities] == \
        [type(e).__name__ for e in jdyn.entities]
    _assert_same(pdyn.at_time(t).to_numpy(),
                 flatten_jax_scene(jdyn.at_time(t)))


def _assert_spun_tables(mine: dict, flat: dict, normals_atol=None):
    """Every table exact except the mesh: leaf order exact, positions
    within 1e-6 (XLA may contract the rotation into FMAs), normals within
    ``normals_atol`` when given."""
    assert sorted(mine) == sorted(flat)
    for k in mine:
        assert mine[k].dtype == flat[k].dtype, k
        if k in MESH_POS:
            np.testing.assert_allclose(mine[k], flat[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        elif k == "mesh.n":
            if normals_atol is not None:
                np.testing.assert_allclose(mine[k], flat[k], rtol=0,
                                           atol=normals_atol, err_msg=k)
        else:
            np.testing.assert_array_equal(mine[k], flat[k], err_msg=k)


def test_spinning_mesh_builder_equals_jax():
    jdyn, pdyn = jshow.build_spinning_mesh(), showcase_scenes.build_spinning_mesh()
    _assert_spun_tables(pdyn.base.to_numpy(), flatten_jax_scene(jdyn.base),
                        normals_atol=1e-6)
    (je,), (pe,) = jdyn.entities, pdyn.entities
    assert pe.a0.shape == (3840, 3) and pe.mat.dtype == torch.int32
    for f in ("a0", "b0", "c0", "mat"):
        np.testing.assert_array_equal(getattr(pe, f).numpy(),
                                      np.asarray(getattr(je, f)), err_msg=f)
    np.testing.assert_array_equal(np.float32(pe.pivot), np.float32(je.pivot))
    assert pe.spin_hz == je.spin_hz


@pytest.mark.parametrize("t", [0.0, 1.3, 2.0])
def test_spinning_mesh_at_time_equals_jax(t):
    jdyn, pdyn = jshow.build_spinning_mesh(), showcase_scenes.build_spinning_mesh()
    _assert_spun_tables(pdyn.at_time(t).to_numpy(),
                        flatten_jax_scene(jdyn.at_time(t)))


@jax.jit
def _jax_rotation(v, ang, pivot):
    """The rotation inside the JAX package's ``entities._spin_lbvh``."""
    ca, sa = jnp.cos(ang), jnp.sin(ang)
    p = v - pivot
    x = p[:, 0] * ca + p[:, 2] * sa
    z = -p[:, 0] * sa + p[:, 2] * ca
    return jnp.stack([x, p[:, 1], z], axis=1) + pivot


def test_spun_vertices_and_lbvh_equal_jax():
    """At t = 2.0: the spun vertices within 1e-6 of the JAX rotation, the
    per-frame LBVH equal to ``jax.jit(build_lbvh)`` of the same vertices,
    and the scene's tree that LBVH."""
    t = 2.0
    (pe,) = showcase_scenes.build_spinning_mesh().entities
    ang = np.float32(2.0 * np.pi * pe.spin_hz * t)
    spun = [entities.spin_vertices(v, ang, pe.pivot)
            for v in (pe.a0, pe.b0, pe.c0)]
    piv = jnp.asarray(pe.pivot, jnp.float32)
    for v0, v in zip((pe.a0, pe.b0, pe.c0), spun):
        want = np.asarray(_jax_rotation(jnp.asarray(v0.numpy()),
                                        jnp.float32(ang), piv))
        np.testing.assert_allclose(v.numpy(), want, rtol=0, atol=1e-6)
        assert np.abs(v.numpy() - v0.numpy()).max() > 0.5   # it turned
    a, b, c = (v.numpy() for v in spun)
    m = pe.mat.numpy()
    assert_lbvh_equal(torch_lbvh(a, b, c, m),
                      jax.jit(jlbvh.build_lbvh)(a, b, c, jnp.asarray(m)))
    scene = entities.DynamicScene(
        showcase_scenes.build_spinning_mesh().base, [pe]).at_time(t)
    for f in ("bmin", "a", "n", "mat"):
        assert torch.equal(getattr(scene.mesh, f),
                           getattr(torch_lbvh(a, b, c, m), f)), f
    assert torch.equal(scene.mesh_soup.a, spun[0])


def test_dynamic_scene_update_and_move():
    """update advances time; ``to`` keeps it and moves the entities'
    tensors; at_time is a pure function of t."""
    dyn = showcase_scenes.build_spinning_mesh()
    s1 = dyn.update(0.5)
    s2 = dyn.update(0.25)
    assert dyn.t == 0.75
    moved = dyn.to("cpu")
    assert moved.t == 0.75 and moved.device == torch.device("cpu")
    assert torch.equal(moved.at_time(0.75).mesh.bmin, s2.mesh.bmin)
    assert not torch.equal(s1.mesh.bmin, s2.mesh.bmin)
    assert torch.equal(dyn.at_time(0.5).mesh.a, s1.mesh.a)
    ring = showcase_scenes.build_exhibit_ring()
    a, b = ring.at_time(0.0), ring.update(0.5)
    assert not torch.equal(a.lights.pos, b.lights.pos)
    assert not torch.equal(a.spheres.center, b.spheres.center)
    assert a.lights.pos.shape == b.lights.pos.shape


def test_render_many_with_scene_fn_equals_per_frame_updates():
    """render_many(times=, scene_fn=) against the same frames rendered
    one by one after DynamicScene.update: fg grids bit-equal, RGB within
    1/255 (the batch's RGB planes ship as display u8)."""
    w, h, n, dt = 20, 12, 3, 1.0 / 30.0
    dyn = showcase_scenes.build_spinning_mesh()
    one = RaytraceRenderer(dyn.base, w, h, device="cpu")
    one.set_scene(dyn.at_time(0.0), static=False)
    seq = []
    for _ in range(n):
        one.scene = dyn.update(dt)
        out = one.render()
        seq.append((out.fg_ansi.numpy(), out.top_rgb.numpy()))
    batch_dyn = showcase_scenes.build_spinning_mesh()
    many = RaytraceRenderer(batch_dyn.base, w, h, device="cpu")
    many.set_scene(batch_dyn.at_time(0.0), static=False)
    times = [dt * (k + 1) for k in range(n)]
    grids, _ = many.render_many(n, rgb=True, times=times,
                                scene_fn=batch_dyn.at_time)
    for k, (fg, top) in enumerate(seq):
        np.testing.assert_array_equal(grids[0][k].numpy(), fg,
                                      err_msg=f"frame {k}")
        np.testing.assert_allclose(grids[2][k].numpy() / 255.0, top,
                                   atol=1 / 255.0, err_msg=f"frame {k}")
    assert not np.array_equal(seq[0][0], seq[-1][0])   # it moved


def test_scene_fn_refuses_the_trace_kernel_tables():
    r = RaytraceRenderer(builders.SCENE_BUILDERS["cornell"](), 8, 6,
                         device="cpu")
    assert not isinstance(r.packed, type(r.scene))
    dyn = showcase_scenes.build_exhibit_ring()
    with pytest.raises(ValueError, match="static=False"):
        r.render_many(1, times=[0.0], scene_fn=dyn.at_time)


def test_spinning_mesh_frame_matches_jax():
    """spinning_mesh at 16x10, t = 0 then t = 2.0 (one TAA history): the
    port's plain renderer against one jitted JAX frame_step, RGB within
    2e-3 and ANSI flips under 0.5%, as the goldens are held."""
    from yetanotherconsolegameengine_tpu.render.renderer import (
        frame_step, init_state)
    w, h = 16, 10
    jdyn = jshow.build_spinning_mesh()
    step = jax.jit(lambda s, c, st: frame_step(s, c, st, fb_w=w, fb_h=h,
                                               ss=1))
    state = init_state(w, h, 1)
    pdyn = showcase_scenes.build_spinning_mesh()
    r = RaytraceRenderer(pdyn.base, w, h, device="cpu")
    r.set_scene(pdyn.at_time(0.0), static=False)
    for t in (0.0, 2.0):
        js = jdyn.at_time(t)
        want, state = step(js, js.default_pose, state)
        r.scene = pdyn.at_time(t)
        got = r.render()
        for g, wnt in ((got.top_rgb, want.top_rgb),
                       (got.bot_rgb, want.bot_rgb)):
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt),
                                       rtol=0, atol=2e-3, err_msg=f"t={t}")
        flips = np.mean([
            (got.fg_ansi.numpy() != np.asarray(want.fg_ansi)).mean(),
            (got.bg_ansi.numpy() != np.asarray(want.bg_ansi)).mean()])
        assert flips < 0.005, (t, flips)
        assert int(got.rays_traced) == int(want.rays_traced), t
