"""The port's voxel DDA (ops/dda.py) against the JAX package's: the distance
encoding exactly, ``intersect_voxels`` on the voxel cave's grid and on the
cases of tests/test_dda.py (equal hits, materials and normals, t within
1e-5), rays through cell edges, the compacted loop against the
uncompacted one bit for bit, and the voxel branch of ``intersect_scene``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yetanotherconsolegameengine_tpu.ops import dda as jdda
from yetanotherconsolegameengine_tpu.ops import intersect as jint
from yetanotherconsolegameengine_tpu.scene import voxel_scenes as jvox
from yetanotherconsolegameengine_tpu_torch.core.camera import (
    make_jittered_rays, ray_params)
from yetanotherconsolegameengine_tpu_torch.ops import dda, trace_kernel
from yetanotherconsolegameengine_tpu_torch.ops.intersect import (
    INF, intersect_boxes, intersect_scene)
from yetanotherconsolegameengine_tpu_torch.scene import voxel_scenes

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)


def _both(cells, origin, h, o, d, tmin=1e-3, tmax=1e9):
    """(JAX hit, port hit) of the same rays through the same grid."""
    jw = jdda.build_voxel_world(cells, origin, h)
    pw = dda.build_voxel_world(cells, origin, h, device="cpu")
    np.testing.assert_array_equal(pw.cells.numpy(), np.asarray(jw.cells))
    want = jdda.intersect_voxels(jw, jnp.asarray(o), jnp.asarray(d),
                                 np.float32(tmin), np.float32(tmax))
    got = dda.intersect_voxels(pw, torch.from_numpy(o), torch.from_numpy(d),
                               tmin, tmax)
    return want, got


def _hold(want, got):
    """Equal hit masks, materials and normals; t within 1e-5 (XLA fuses
    the boundary's multiply-add, so t can differ by an ulp)."""
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(want.mat))
    np.testing.assert_array_equal(got.n.numpy()[hit],
                                  np.asarray(want.n)[hit])
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5,
                               atol=1e-5)


def _cave_rays():
    """The voxel cave's grid, ~2,000 primary rays of its camera and 400
    rays through cell edges and corners (ties between axes)."""
    scene = voxel_scenes.build_voxel_cave_scene()
    params = ray_params(scene.default_pose, 48, 42, 1)
    o, d = (x.reshape(-1, 3).numpy()
            for x in make_jittered_rays(None, 48, 42, 1, params=params))
    w = scene.voxels
    org, h = w.origin.numpy(), float(w.voxel_size)
    rng = np.random.RandomState(3)
    corner = org + h * rng.randint(0, 24, (400, 3)).astype(np.float32)
    diag = np.float32([[1, 1, 0], [1, 0, -1], [0, -1, 1], [1, 1, 1],
                       [-1, -1, -1]])[rng.randint(0, 5, 400)]
    diag /= np.linalg.norm(diag, axis=1, keepdims=True)
    o = np.concatenate([o, corner - 7.0 * h * diag]).astype(np.float32)
    d = np.concatenate([d, diag]).astype(np.float32)
    return scene, o, d


def test_encode_cells_equals_jax():
    rng = np.random.RandomState(0)
    cells = ((rng.rand(24, 16, 24) < 0.08)
             * rng.randint(1, 9, (24, 16, 24))).astype(np.int16)
    want = np.asarray(jdda.encode_cells(jnp.asarray(cells)))
    got = dda.encode_cells(torch.from_numpy(cells))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        dda.cell_distance_field(torch.from_numpy(cells)).numpy(),
        np.asarray(jdda.cell_distance_field(jnp.asarray(cells))))


def test_intersect_voxels_matches_jax_on_the_cave():
    scene, o, d = _cave_rays()
    w = scene.voxels
    jw = jdda.VoxelWorld(cells=jnp.asarray(w.cells.numpy()),
                         origin=jnp.asarray(w.origin.numpy()),
                         voxel_size=jnp.asarray(w.voxel_size.numpy()))
    want = jdda.intersect_voxels(jw, jnp.asarray(o), jnp.asarray(d),
                                 np.float32(1e-3), np.float32(INF))
    got = dda.intersect_voxels(w, torch.from_numpy(o), torch.from_numpy(d),
                               1e-3, INF)
    assert 1000 < int(got.hit.sum()) < len(o)
    _hold(want, got)


@pytest.mark.parametrize("case", ["brute_force", "entry_faces", "brick_skip",
                                  "inside_start", "materials"])
def test_intersect_voxels_matches_jax_on_the_dda_cases(case):
    """The cases of tests/test_dda.py: the port equals the JAX function
    and meets the same expectations."""
    if case == "brute_force":
        rng = np.random.RandomState(0)
        cells = (rng.rand(12, 9, 14) < 0.12).astype(np.int32) * 3
        origin, h = np.float32([-5.0, -3.0, -7.0]), 0.8
        lo, hi = origin, origin + np.float32(cells.shape) * h
        o = lo + (hi - lo) * rng.rand(512, 3) + 30 * (rng.rand(512, 3) - 0.5)
        d = rng.randn(512, 3)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d = o.astype(np.float32), d.astype(np.float32)
    elif case == "entry_faces":
        cells = np.zeros((8, 8, 8), np.int32)
        cells[4, 4, 4] = 1
        origin, h = (0.0, 0.0, 0.0), 1.0
        c = np.float32([4.5, 4.5, 4.5])
        o = (c + 3.0 * np.float32([[-1, 0, 0], [1, 0, 0], [0, -1, 0],
                                   [0, 1, 0], [0, 0, -1], [0, 0, 1]]))
        d = (c[None] - o) / 3.0
    elif case == "brick_skip":
        cells = np.zeros((dda.BRICK * 8, dda.BRICK, dda.BRICK), np.int32)
        cells[-1] = 2
        origin, h = (0.0, 0.0, 0.0), 1.0
        o, d = np.float32([[0.5, 4.0, 4.0]]), np.float32([[1.0, 0.0, 0.0]])
    elif case == "inside_start":
        cells = np.ones((8, 8, 8), np.int32)
        origin, h = (0.0, 0.0, 0.0), 1.0
        o, d = np.float32([[4.0, 4.0, 4.0]]), np.float32([[0.0, 1.0, 0.0]])
    else:
        cells = np.zeros((8, 8, 8), np.int32)
        cells[2, 2, 2] = 5
        cells[6, 2, 2] = 9
        origin, h = (0.0, 0.0, 0.0), 1.0
        o = np.float32([[2.5, 2.5, -2.0], [6.5, 2.5, -2.0]])
        d = np.float32([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    want, got = _both(cells, origin, h, o.astype(np.float32),
                      d.astype(np.float32))
    _hold(want, got)
    if case == "brute_force":
        assert int(got.hit.sum()) > 20
    elif case == "entry_faces":
        assert bool(got.hit.all())
        np.testing.assert_allclose(got.n.numpy(), -d, atol=1e-5)
        np.testing.assert_allclose(got.t.numpy(), 2.5, atol=1e-3)
    elif case == "brick_skip":
        assert abs(float(got.t[0]) - (dda.BRICK * 8 - 1.5)) < 1e-3
    elif case == "inside_start":
        assert bool(got.hit[0]) and float((got.n[0] * got.n.new_tensor(
            d[0])).sum()) < 0.0
    else:
        assert got.mat.tolist() == [5, 9]


@pytest.mark.parametrize("check_every", [1, 8])
def test_compacted_loop_equals_uncompacted(monkeypatch, check_every):
    """Narrowing to the marching lanes changes no result bit, whatever the
    host-check cadence."""
    scene, o, d = _cave_rays()
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    monkeypatch.setattr(dda, "CHECK_EVERY", check_every)
    dda.STATS.clear()
    got = dda.intersect_voxels(scene.voxels, o, d, 1e-3, INF)
    assert dda.STATS["compactions"] >= 1
    assert dda.STATS["waits"] * check_every == dda.STATS["rounds"]
    want = dda.intersect_voxels(scene.voxels, o, d, 1e-3, INF,
                                compact=False)
    for k in ("t", "n", "mat", "hit"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def test_intersect_scene_voxel_branch_matches_jax():
    """The voxel branch of ``intersect_scene`` (after the primitives and
    meshes, clipped to their nearest hit) on the DDA form of the voxel
    test room, with a box in front of part of it; and the trace kernel
    refuses voxel scenes."""
    import dataclasses

    from yetanotherconsolegameengine_tpu.scene.materials import (
        Material as JMat)
    from yetanotherconsolegameengine_tpu_torch.scene.materials import Material
    from yetanotherconsolegameengine_tpu_torch.scene.tables import SceneBuilder

    def room(vox, builder, mat):
        sb = builder("clip")
        sb.add_box((-2.0, 1.0, -9.0), (0.0, 3.0, -8.0), mat.solid((1, 0, 0)))
        s = vox.build_voxel_test_scene(merge="dda")
        return dataclasses.replace(s, boxes=sb.build().boxes)

    from yetanotherconsolegameengine_tpu.scene.tables import (
        SceneBuilder as JSceneBuilder)
    jsc = room(jvox, JSceneBuilder, JMat)
    psc = room(voxel_scenes, SceneBuilder, Material)
    assert not trace_kernel.scene_fits(psc)
    params = ray_params(psc.default_pose, 40, 30, 2)
    o, d = (x.reshape(-1, 3) for x in make_jittered_rays(
        None, 40, 30, 2, params=params))
    want = jint.intersect_scene(jsc, jnp.asarray(o.numpy()),
                                jnp.asarray(d.numpy()), 1e-3, INF)
    got = intersect_scene(psc, o, d, 1e-3, INF)
    box = intersect_boxes(psc.boxes, o, d, 1e-3, INF)
    in_front = box.hit & (box.t <= got.t)
    assert 0 < int(in_front.sum()) < int(got.hit.sum()) - 100
    _hold(want, got)
