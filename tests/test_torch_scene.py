"""The port's numpy scene builders against the JAX package's: equal tables,
and the numpy carry-across of a JAX scene (its LBVH and texture bank
included)."""

import dataclasses

import numpy as np
import pytest
import torch

from yetanotherconsolegameengine_tpu.scene import builders as jbuilders
from yetanotherconsolegameengine_tpu_torch.scene import builders, tables
from yetanotherconsolegameengine_tpu_torch.scene.materials import (
    PROC_CELL_TINT, PROC_TEXTURE, Material, MaterialBank)

SCENES = ["test", "cornell", "mirror_spheres", "primitives", "boxes",
          "glass", "demo_random", "texture_test"]
MESH_FIELDS = ("bmin", "bmax", "skip", "tri_start", "tri_count", "a", "e1",
               "e2", "n", "mat")


def flatten_jax_scene(sc) -> dict:
    """A JAX SceneData as the flat numpy dict scene_from_numpy reads."""
    d = {}
    for tname in ("materials", "lights") + tables.PRIMITIVE_TABLES:
        tb = getattr(sc, tname)
        for f in dataclasses.fields(tb):
            d[f"{tname}.{f.name}"] = np.asarray(getattr(tb, f.name))
    for k in ("ambient_color", "ambient_intensity", "bg_top", "bg_bottom"):
        d[k] = np.asarray(getattr(sc, k))
    d["name"] = np.asarray(sc.name)
    d["binary_shadows"] = np.asarray(sc.binary_shadows)
    d["defaults"] = np.asarray(sc.defaults, np.float64)
    if sc.mesh_clusters is not None:
        d["mesh_clusters"] = np.ones(1, np.bool_)
    if sc.voxels is not None:
        for f in ("cells", "origin", "voxel_size"):
            d[f"voxels.{f}"] = np.asarray(getattr(sc.voxels, f))
    if sc.mesh is not None:
        for f in MESH_FIELDS:
            d[f"mesh.{f}"] = np.asarray(getattr(sc.mesh, f))
        d["mesh_all_opaque"] = np.asarray(sc.mesh_all_opaque)
    if sc.textures is not None:
        d["textures"] = np.asarray(sc.textures)
    if sc.has_dynamic_textures:
        d["has_dynamic_textures"] = np.asarray(True)
    return d


def _assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("name", SCENES)
def test_builder_tables_equal_jax(name):
    jsc = jbuilders.SCENE_BUILDERS[name]()
    psc = builders.SCENE_BUILDERS[name]()
    flat = flatten_jax_scene(jsc)
    _assert_same(psc.to_numpy(), flat)
    assert psc.any_transparent == jsc.any_transparent
    # The carry-across reproduces the same scene.
    carried = tables.scene_from_numpy(flat)
    _assert_same(carried.to_numpy(), flat)
    assert carried.any_transparent == jsc.any_transparent


def test_scene_from_numpy_refuses_what_is_not_ported():
    """Textures, meshes and voxel worlds carry across (a JAX VoxelWorld
    arrives equal, cell for cell); an unknown key raises KeyError."""
    flat = flatten_jax_scene(jbuilders.SCENE_BUILDERS["texture_test"]())
    carried = tables.scene_from_numpy(flat)
    np.testing.assert_array_equal(carried.textures.numpy(), flat["textures"])
    assert carried.textures.shape == (1, 64, 64, 3)
    from yetanotherconsolegameengine_tpu.scene.voxel_scenes import (
        build_voxel_test_scene)
    flat = flatten_jax_scene(build_voxel_test_scene(merge="dda"))
    carried = tables.scene_from_numpy(flat)
    assert carried.voxels.cells.dtype == torch.int16
    assert carried.voxels.dims == (16, 8, 16) and carried.binary_shadows
    _assert_same(carried.to_numpy(), {k: v for k, v in flat.items()})
    with pytest.raises(KeyError):
        tables.scene_from_numpy(dict(flat, lod=np.ones(1)))


def test_texture_material_raises():
    """Texture and per-cell tint materials build now; only a proc that
    ``sample_albedo`` does not know raises."""
    bank = MaterialBank()
    bank.add(Material(proc=PROC_TEXTURE, tex_id=0))
    bank.add(Material(proc=PROC_CELL_TINT))
    assert bank.build().proc.tolist() == [0, PROC_TEXTURE, PROC_CELL_TINT]
    bank.add(Material(proc=7))
    with pytest.raises(ValueError, match="proc"):
        bank.build()


def test_scene_to_device_keeps_values():
    sc = builders.SCENE_BUILDERS["glass"]()
    moved = sc.to("cpu")
    _assert_same(moved.to_numpy(), sc.to_numpy())
    np.testing.assert_array_equal(moved.default_pose.pos.numpy(),
                                  np.float32([0.0, 1.2, 0.5]))
