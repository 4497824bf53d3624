"""Voxel scenes and the block palette.

Port of ``yetanotherconsolegameengine_tpu/scene/voxel_scenes.py``, in numpy
(the JAX module builds its tables with jax). ``block_material`` maps a
(block id, meta) pair to a ``Material`` through a fixed console-16-aligned
color set; every pair a grid uses is baked into the scene's material bank
and the voxel cells hold bank ids.

``build_voxel_test_scene`` is the 16x8x16 walled test room with one pillar
per block type. With ``merge="auto"`` it greedy-meshes to about 23 solid
boxes, which the trace kernel takes; with ``merge="dda"`` it keeps the
voxel grid (ops/dda.py) and binary shadows. ``build_voxel_cave_scene`` is
a 48x24x48 noise cavern traced by the DDA. The grids are encoded on the
host, like the other scenes' tables; ``SceneData.to`` moves them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..ops.dda import build_voxel_world
from .materials import Material
from .tables import SceneBuilder, SceneData

# Block ids (WorldGeneration/WorldGenSettings.cs:8-22).
AIR = 0
GRASS = 1
DIRT = 2
STONE = 3
SAND = 4
WATER = 5
SNOW = 6
WOOD = 7
LEAVES = 8
LANTERN = 9
GRAVEL = 10
FLOWER = 11

# Console-16-aligned base colors per block (VoxelMaterialPalette.cs).
_BLOCK_COLORS: Dict[int, Tuple[float, float, float]] = {
    GRASS: (0.30, 0.65, 0.25),
    DIRT: (0.45, 0.30, 0.18),
    STONE: (0.50, 0.50, 0.52),
    SAND: (0.86, 0.80, 0.55),
    WATER: (0.15, 0.35, 0.70),
    SNOW: (0.95, 0.95, 0.97),
    WOOD: (0.42, 0.28, 0.15),
    LEAVES: (0.20, 0.45, 0.15),
    LANTERN: (1.00, 0.85, 0.55),
    GRAVEL: (0.40, 0.40, 0.40),
    FLOWER: (0.85, 0.30, 0.55),
}


def block_material(block: int, meta: int = 0) -> Material:
    """(id, meta) -> Material (VoxelMaterialPalette.MaterialLookup).

    meta darkens/lightens stone strata bands (StrataMap.RockMetaAt) and
    tints grass/leaves variation.
    """
    base = _BLOCK_COLORS.get(block, (0.8, 0.2, 0.8))
    f = 1.0 + 0.08 * ((meta % 5) - 2)
    rgb = tuple(float(np.clip(c * f, 0.0, 1.0)) for c in base)
    if block == LANTERN:
        return Material(albedo=rgb, emission=(2.2, 1.7, 0.9))
    if block == WATER:
        return Material(albedo=rgb, specular=0.4, reflectivity=0.12,
                        transparency=0.55, ior=1.33,
                        transmission=(0.5, 0.7, 0.95))
    if block == SNOW:
        return Material(albedo=rgb, specular=0.08)
    return Material(albedo=rgb)


class VoxelGridBuilder:
    """Host-side (block, meta) grid -> VoxelWorld with bank ids: a dense
    (nx, ny, nz) array authored in block ids, converted to material-bank
    ids at build."""

    def __init__(self, nx: int, ny: int, nz: int, origin=(0.0, 0.0, 0.0),
                 voxel_size: float = 1.0):
        self.blocks = np.zeros((nx, ny, nz), np.int32)
        self.meta = np.zeros((nx, ny, nz), np.int32)
        self.origin = tuple(float(v) for v in origin)
        self.voxel_size = float(voxel_size)

    def set(self, x, y, z, block: int, meta: int = 0):
        self.blocks[x, y, z] = block
        self.meta[x, y, z] = meta

    def fill(self, lo, hi, block: int, meta: int = 0):
        sl = tuple(slice(a, b) for a, b in zip(lo, hi))
        self.blocks[sl] = block
        self.meta[sl] = meta

    def attach(self, scene: SceneBuilder, merge: str = "auto"):
        """Attach the grid to the scene.

        ``merge="auto"`` greedy-meshes SMALL static grids into solid boxes
        (same first-hit face/normal semantics as the DDA, VolumeGrid.cs
        entry faces == box faces): a 16x8x16 room collapses to ~25 boxes,
        which the trace kernel takes instead of the DDA march. Big or
        streaming grids keep the VoxelWorld and the DDA.
        """
        if merge == "auto":
            merge = "boxes" if self.blocks.size <= 32768 else "dda"
        if merge == "boxes":
            boxes = greedy_mesh_boxes(self.blocks, self.meta)
            if len(boxes) <= 120:
                vs = self.voxel_size
                org = np.asarray(self.origin, np.float64)
                for (lo, hi, block, meta) in boxes:
                    scene.add_box(org + np.asarray(lo) * vs,
                                  org + np.asarray(hi) * vs,
                                  block_material(block, meta))
                return None
        cells = bake_cells(scene, self.blocks, self.meta)
        scene.voxels = build_voxel_world(cells, self.origin, self.voxel_size,
                                         device="cpu")
        scene.binary_shadows = True  # VolumeScene's binary occlusion
        return scene.voxels


def greedy_mesh_boxes(blocks: np.ndarray, meta: np.ndarray):
    """Greedy 3-D merge of same-(block, meta) runs into boxes.

    Returns [(lo_idx, hi_idx, block, meta), ...] with hi exclusive. The
    classic Minecraft-style mesher: grow each unvisited solid cell's box
    along x, then y, then z while every cell in the slab matches and is
    unvisited. O(cells) passes over <=32^3 grids, host-side, build-time.
    """
    key = np.where(blocks > 0, blocks.astype(np.int64) * 64
                   + (meta.astype(np.int64) % 5), 0)
    nx, ny, nz = key.shape
    seen = np.zeros_like(key, bool)
    out = []
    for x in range(nx):
        for y in range(ny):
            for z in range(nz):
                k = key[x, y, z]
                if k == 0 or seen[x, y, z]:
                    continue
                x1 = x + 1
                while x1 < nx and key[x1, y, z] == k and not seen[x1, y, z]:
                    x1 += 1
                y1 = y + 1
                while (y1 < ny and (key[x:x1, y1, z] == k).all()
                       and not seen[x:x1, y1, z].any()):
                    y1 += 1
                z1 = z + 1
                while (z1 < nz and (key[x:x1, y:y1, z1] == k).all()
                       and not seen[x:x1, y:y1, z1].any()):
                    z1 += 1
                seen[x:x1, y:y1, z:z1] = True
                out.append(((x, y, z), (x1, y1, z1),
                            int(k // 64), int(k % 64)))
    return out


def bake_cells(scene: SceneBuilder, blocks: np.ndarray,
               meta: np.ndarray) -> np.ndarray:
    """Vectorized (block, meta) -> material-bank-id conversion."""
    key = blocks.astype(np.int64) * 64 + (meta.astype(np.int64) % 5)
    cells = np.zeros(blocks.shape, np.int32)
    for k in np.unique(key):
        if k // 64 == AIR:
            continue
        b, m = int(k // 64), int(k % 64)
        mid = scene.bank.add(block_material(b, m))
        cells[key == k] = mid
    return cells


def build_voxel_test_scene(merge: str = "auto") -> SceneData:
    """16x8x16 test room with a block legend.

    With ``merge="auto"`` the room greedy-meshes to ~23 solid boxes and
    takes the trace kernel; shadows then use the standard colored
    transmittance. ``merge="dda"`` keeps the voxel grid (the DDA test
    path) with binary shadows.
    """
    s = SceneBuilder("voxel_test")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.08
    g = VoxelGridBuilder(16, 8, 16, origin=(-8.0, 0.0, -16.0))
    # Floor + three walls.
    g.fill((0, 0, 0), (16, 1, 16), STONE)
    g.fill((0, 1, 0), (16, 5, 1), STONE, meta=1)
    g.fill((0, 1, 0), (1, 5, 16), STONE, meta=2)
    g.fill((15, 1, 0), (16, 5, 16), STONE, meta=3)
    # Legend pillars: one per block type along the back wall.
    legend = [GRASS, DIRT, SAND, WATER, SNOW, WOOD, LEAVES, GRAVEL, FLOWER]
    for i, b in enumerate(legend):
        x = 2 + i
        g.fill((x, 1, 2), (x + 1, 2 + (i % 3), 3), b)
    # A small "tree".
    g.fill((8, 1, 8), (9, 4, 9), WOOD)
    g.fill((7, 3, 7), (10, 6, 10), LEAVES)
    g.set(8, 4, 8, WOOD)
    # Lanterns light the room.
    g.set(3, 3, 12, LANTERN)
    g.set(12, 3, 12, LANTERN)
    g.attach(s, merge=merge)
    s.add_light((0.0, 7.0, -8.0), (1.0, 0.95, 0.85), 90.0)
    s.bg_top = (0.55, 0.75, 1.0)
    s.bg_bottom = (0.95, 0.98, 1.0)
    s.set_camera((0.0, 3.0, 2.0), pitch=-0.25, fov=60.0)
    return s.build()


def build_voxel_cave_scene(seed: int = 7) -> SceneData:
    """Procedural noise cavern — a denser DDA stress scene."""
    s = SceneBuilder("voxel_cave")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.05
    n = 48
    rng = np.random.RandomState(seed)
    # Smooth random field via separable box blurs of white noise.
    f = rng.rand(n, n, n).astype(np.float32)
    for axis in range(3):
        for _ in range(3):
            f = (f + np.roll(f, 1, axis) + np.roll(f, -1, axis)) / 3.0
    g = VoxelGridBuilder(n, n // 2, n, origin=(-n / 2, 0.0, -n - 4.0))
    solid = f[:, : n // 2, :] > 0.5
    solid[:, 0, :] = True
    g.blocks[solid] = STONE
    g.meta[solid] = (f[:, : n // 2, :][solid] * 10).astype(np.int32)
    # Scatter lanterns in open pockets just above solid ground.
    open_above = solid[:, :-1, :] & ~solid[:, 1:, :]
    xs, ys, zs = np.where(open_above)
    if len(xs):
        pick = rng.choice(len(xs), size=min(24, len(xs)), replace=False)
        g.blocks[xs[pick], ys[pick] + 1, zs[pick]] = LANTERN
    g.attach(s)
    s.add_light((0.0, n, 0.0), (1, 1, 1), 500.0)
    s.bg_top = (0.1, 0.1, 0.15)
    s.bg_bottom = (0.02, 0.02, 0.04)
    s.set_camera((0.0, n / 3.0, 4.0), pitch=-0.35, fov=70.0)
    return s.build()


VOXEL_SCENE_BUILDERS = {
    "voxel_test": build_voxel_test_scene,
    "voxel_cave": build_voxel_cave_scene,
}
