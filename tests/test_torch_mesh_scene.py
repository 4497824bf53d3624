"""The port's mesh host code against the JAX package's: the copied OBJ
loader, procedural meshes and LOD simplification, the cluster packing, the
scene builder's mesh routing with its proxy sets and t_bias, and the numpy
carry-across of a JAX cluster scene."""

import dataclasses

import numpy as np
import pytest

from yetanotherconsolegameengine_tpu.ops import mesh_clusters as jmc
from yetanotherconsolegameengine_tpu.scene import lod as jlod
from yetanotherconsolegameengine_tpu.scene import mesh_loader as jml
from yetanotherconsolegameengine_tpu.scene import tables as jtables
from yetanotherconsolegameengine_tpu.scene.materials import Material as JMat
from yetanotherconsolegameengine_tpu_torch.ops import mesh_clusters as pmc
from yetanotherconsolegameengine_tpu_torch.scene import builders
from yetanotherconsolegameengine_tpu_torch.scene import lod as plod
from yetanotherconsolegameengine_tpu_torch.scene import mesh_loader as pml
from yetanotherconsolegameengine_tpu_torch.scene import tables as ptables
from yetanotherconsolegameengine_tpu_torch.scene.materials import (
    Material as PMat)
from tests.test_torch_scene import flatten_jax_scene

SETS = ptables.CLUSTER_SETS
_FIELDS = ("cbmin", "cbmax", "gmat", "tri_rows", "bounds")

_OBJ = """# a quad, a triangle with negative indices, a pentagon
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f 1 2 3 4
v 2 0 1
v 3 0 1
v 2 2 1
f -3/1 -2/2 -1/3
v 0 0 2
v 1 0 2
v 1.5 1 2
v 0.5 2 2
v -0.5 1 2
f 8 9 10 11 12
"""


@pytest.mark.parametrize("make,args", [
    ("make_icosphere", (3,)), ("make_torus", ()), ("make_knot", ()),
    ("make_gem", ()), ("make_dragon", (96, 24))])
def test_procedural_meshes_equal_jax(make, args):
    want = getattr(jml, make)(*args)
    got = getattr(pml, make)(*args)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    tw = jml.transform_mesh(want, normalize=True, scale=2.6,
                            translate=(0.0, 0.0, -3.5))
    tg = pml.transform_mesh(got, normalize=True, scale=2.6,
                            translate=(0.0, 0.0, -3.5))
    np.testing.assert_array_equal(tg, tw)
    for a, b in zip(pml.mesh_bounds(tg), jml.mesh_bounds(tw)):
        np.testing.assert_array_equal(a, b)


def test_load_obj_and_find_asset_equal_jax(tmp_path):
    path = tmp_path / "poly.obj"
    path.write_text(_OBJ)
    for kw in (dict(), dict(normalize=False, scale=0.5, translate=(1, 2, 3))):
        got = pml.load_obj(str(path), **kw)
        assert got.shape == (2 + 1 + 3, 3, 3)
        np.testing.assert_array_equal(got, jml.load_obj(str(path), **kw))
    # The OBJ assets are not part of the checkout: both return None and the
    # mesh scenes fall back to their procedural stand-ins.
    for name in ("stanford-bunny.obj", "xyzrgb_dragon.obj", "teapot.obj"):
        assert pml.find_asset(name) is None
        assert jml.find_asset(name) is None


@pytest.mark.parametrize("target", [2048, 512, 128, 6000])
def test_simplify_soup_equals_jax(target):
    tris = jml.make_icosphere(4) * 1.3
    mats = (np.arange(len(tris)) % 3).astype(np.int32)
    want = jlod.simplify_soup(tris, mats, target)
    got = plod.simplify_soup(tris, mats, target)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    if target < len(tris):
        assert got[0].shape[0] <= target and got[2] > 0.0
    else:
        assert got[0] is not None and got[2] == 0.0


@pytest.mark.parametrize("kc", [128, 256, 512])
def test_pack_cluster_blocks_equals_jax(kc):
    """Equal element for element; the JAX gmat's 4 zero pad rows per field
    group are dropped by gmat_from_jax."""
    tris = np.concatenate([jml.make_icosphere(3) * 1.3,
                           jml.make_knot(seg_u=40, seg_v=6) * 0.5])
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    mats = (np.arange(len(tris)) % 7).astype(np.int32)
    want = jmc.pack_cluster_blocks(a, b, c, mats, kc=kc)
    got = pmc.pack_cluster_blocks(a, b, c, mats, kc=kc)
    assert len(tris) % kc, "the last cluster must hold padding slots"
    assert got[2].shape == (want[2].shape[0], 12, kc)
    np.testing.assert_array_equal(np.asarray(want[2])[:, 4::8], 0.0)
    np.testing.assert_array_equal(np.asarray(want[2])[:, 5::8], 0.0)
    for g, w in zip(got, (want[0], want[1], pmc.gmat_from_jax(want[2]),
                          want[3])):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _jax_flat(sc) -> dict:
    """A JAX cluster scene as the flat numpy dict scene_from_numpy reads,
    cluster sets in the JAX layout."""
    d = flatten_jax_scene(dataclasses.replace(sc, mesh_clusters=None))
    for sname in SETS:
        mc = getattr(sc, sname)
        if mc is None:
            continue
        for f in _FIELDS:
            d[f"{sname}.{f}"] = np.asarray(getattr(mc, f))
        d[f"{sname}.t_bias"] = np.asarray(mc.t_bias, np.float64)
    d["mesh_all_opaque"] = np.asarray(sc.mesh_all_opaque)
    return d


def _mesh_scene(T, Mat, tris, transparent=False):
    s = T.SceneBuilder("mesh")
    s.add_xz_rect(-6.0, 6.0, -6.0, 3.0, 0.0,
                  Mat.checker((0.8, 0.8, 0.8), (0.2, 0.2, 0.2), 0.8))
    s.add_light((2.0, 4.0, 2.0), (1.0, 1.0, 1.0), 60.0)
    s.add_mesh_triangles(tris, Mat.glass() if transparent
                         else Mat.solid((0.9, 0.85, 0.8)))
    s.set_camera((0.0, 1.2, 1.0), fov=60.0)
    return s.build()


def _assert_scene_equal(psc, jsc, expect_sets):
    flat = _jax_flat(jsc)
    for sname in SETS:
        assert (getattr(psc, sname) is not None) == (sname in expect_sets)
        assert (getattr(jsc, sname) is not None) == (sname in expect_sets)
        if sname in expect_sets:
            assert getattr(psc, sname).t_bias == getattr(jsc, sname).t_bias
    assert psc.mesh_all_opaque == jsc.mesh_all_opaque
    assert psc.any_transparent == jsc.any_transparent
    mine = psc.to_numpy()
    carried = ptables.scene_from_numpy(flat)
    assert sorted(mine) == sorted(flat)
    for k in mine:
        want = flat[k]
        if k.endswith(".gmat"):
            want = pmc.gmat_from_jax(want)
        np.testing.assert_array_equal(mine[k], want, err_msg=k)
    # The carry-across rebuilds the same port scene, and round-trips.
    again = carried.to_numpy()
    for k in mine:
        np.testing.assert_array_equal(again[k], mine[k], err_msg=k)
    back = ptables.scene_from_numpy(again)
    assert back.mesh_clusters.kc == psc.mesh_clusters.kc


def test_builder_routing_equals_jax_at_real_thresholds():
    """81,920 triangles: the full set (kc=256), a LOD set and a shadow set
    (kc=512) with composed t_bias; no fine set (below 3 x 98,304)."""
    tris = jml.transform_mesh(jml.make_icosphere(6), scale=1.4,
                              translate=(0.0, 0.9, -2.5))
    jsc = _mesh_scene(jtables, JMat, tris)
    psc = _mesh_scene(ptables, PMat, tris)
    _assert_scene_equal(psc, jsc, {"mesh_clusters", "mesh_clusters_lod",
                                   "mesh_clusters_shadow"})
    assert psc.mesh_clusters.kc == 256 and psc.mesh_clusters_lod.kc == 512
    lod, shadow = psc.mesh_clusters_lod, psc.mesh_clusters_shadow
    assert shadow.t_bias > lod.t_bias > 0.0


@pytest.mark.parametrize("transparent", [False, True])
def test_builder_routing_with_fine_set_equals_jax(monkeypatch, transparent):
    """Every proxy set (fine, LOD, shadow) at small budgets: the routing
    thresholds are module constants in both packages, lowered together."""
    for mod in (jtables, ptables):
        monkeypatch.setattr(mod, "CLUSTER_MIN_TRIS", 1024)
        monkeypatch.setattr(mod, "PRIMARY_LOD_TARGET_TRIS", 1024)
        monkeypatch.setattr(mod, "LOD_TARGET_TRIS", 1024)
        monkeypatch.setattr(mod, "SHADOW_LOD_TARGET_TRIS", 256)
    tris = jml.transform_mesh(jml.make_icosphere(4), scale=1.3,
                              translate=(0.0, 0.9, -2.4))
    jsc = _mesh_scene(jtables, JMat, tris, transparent)
    psc = _mesh_scene(ptables, PMat, tris, transparent)
    _assert_scene_equal(psc, jsc, set(SETS))
    assert psc.mesh_all_opaque == (not transparent)
    fine = psc.mesh_clusters_fine
    assert fine.t_bias == 0.0 and psc.mesh_clusters_lod.t_bias > 0.0


def test_small_meshes_raise_with_the_lbvh_item():
    """Meshes under CLUSTER_MIN_TRIS no longer raise: each builds an LBVH
    (and keeps its soup), never cluster tables; the dragon still takes the
    cluster path, and a voxel field carries across beside a mesh."""
    for name in ("bunny", "teapot", "cow", "glass_gem", "all_meshes"):
        sc = builders.SCENE_BUILDERS[name]()
        assert sc.mesh is not None and sc.mesh_soup is not None
        assert sc.mesh_clusters is None
        assert sc.mesh_soup.a.shape[0] < ptables.CLUSTER_MIN_TRIS
    assert "dragon" in builders.SCENE_BUILDERS
    from yetanotherconsolegameengine_tpu.scene.voxel_scenes import (
        build_voxel_cave_scene)
    jvox = build_voxel_cave_scene().voxels
    flat = flatten_jax_scene(jtables.SceneBuilder("x").build())
    flat.update({f"voxels.{f}": np.asarray(getattr(jvox, f))
                 for f in ("cells", "origin", "voxel_size")})
    carried = ptables.scene_from_numpy(flat)
    np.testing.assert_array_equal(carried.voxels.cells.numpy(),
                                  np.asarray(jvox.cells))
    assert float(carried.voxels.voxel_size) == float(jvox.voxel_size)
    assert carried.to_numpy()["voxels.origin"].tolist() == \
        np.asarray(jvox.origin).tolist()
