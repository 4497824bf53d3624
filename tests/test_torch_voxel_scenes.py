"""The port's voxel scenes (scene/voxel_scenes.py) against the JAX
package's: the block palette, the greedy box mesher, the baked cells, and
the tables of ``voxel_test`` (boxes and DDA forms) and ``voxel_cave``, its
``VoxelWorld`` included; the routing of each form."""

import numpy as np
import pytest
import torch

from tests.test_torch_scene import _assert_same, flatten_jax_scene
from yetanotherconsolegameengine_tpu.scene import voxel_scenes as jvox
from yetanotherconsolegameengine_tpu.scene.tables import (
    SceneBuilder as JSceneBuilder)
from yetanotherconsolegameengine_tpu_torch.ops import trace_kernel
from yetanotherconsolegameengine_tpu_torch.scene import builders, tables
from yetanotherconsolegameengine_tpu_torch.scene import voxel_scenes as pvox
from yetanotherconsolegameengine_tpu_torch.scene.tables import SceneBuilder

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

CASES = {
    "voxel_test": lambda m: m.build_voxel_test_scene(),
    "voxel_test_dda": lambda m: m.build_voxel_test_scene(merge="dda"),
    "voxel_cave": lambda m: m.build_voxel_cave_scene(),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_voxel_builder_tables_equal_jax(name):
    jsc = CASES[name](jvox)
    psc = CASES[name](pvox)
    flat = flatten_jax_scene(jsc)
    _assert_same(psc.to_numpy(), flat)
    assert (psc.voxels is None) == (jsc.voxels is None)
    assert psc.binary_shadows == jsc.binary_shadows
    assert psc.any_transparent == jsc.any_transparent
    # The boxes form takes the trace kernel; the grids take the wavefront.
    assert trace_kernel.scene_fits(psc) == (psc.voxels is None)
    _assert_same(tables.scene_from_numpy(flat).to_numpy(), flat)


def test_registry_has_the_voxel_scenes():
    for name in ("voxel_test", "voxel_cave"):
        assert builders.SCENE_BUILDERS[name] is pvox.VOXEL_SCENE_BUILDERS[name]
    assert builders.SCENE_BUILDERS["voxel_test"]().boxes.mask.sum() >= 20


def test_block_materials_equal_jax():
    for b in range(13):
        for m in range(7):
            want = jvox.block_material(b, m)
            assert pvox.block_material(b, m).__dict__ == want.__dict__


def test_greedy_boxes_and_baked_cells_equal_jax():
    """Same boxes in the same order, covering every solid cell once with
    its (block, meta); the same bank ids baked into the cells."""
    rng = np.random.RandomState(3)
    blocks = ((rng.rand(9, 7, 8) < 0.35)
              * rng.randint(1, 4, size=(9, 7, 8))).astype(np.int32)
    meta = rng.randint(0, 3, size=blocks.shape)
    boxes = pvox.greedy_mesh_boxes(blocks, meta)
    assert boxes == jvox.greedy_mesh_boxes(blocks, meta)
    cover = np.zeros(blocks.shape, np.int32)
    for (lo, hi, b, m) in boxes:
        sl = tuple(slice(a, c) for a, c in zip(lo, hi))
        cover[sl] += 1
        assert (blocks[sl] == b).all() and ((meta[sl] % 5) == m).all()
    np.testing.assert_array_equal(cover, blocks > 0)
    got = pvox.bake_cells(SceneBuilder("x"), blocks, meta)
    np.testing.assert_array_equal(
        got, jvox.bake_cells(JSceneBuilder("x"), blocks, meta))
