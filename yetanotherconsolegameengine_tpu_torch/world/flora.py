"""Tree placement (FloraPlacer, ConsoleGame/RayTracing/
Scenes/WorldGeneration/FloraPlacer.cs:18-256).

Deterministic hashed per-column placement: forest density 0.03 gated on
slope/water/snow, conifer vs broadleaf canopies chosen per tree hash.
Returns explicit (x, y, z, block) voxel edits so callers can stamp them
into any chunk (chunk-local and global variants share this)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..scene.voxel_scenes import LEAVES, WOOD
from .biome import Biome
from .genmath import hash_u32
from .settings import WorldConfig, WorldGenSettings

Edit = Tuple[int, int, int, int]  # (x, y, z, block)


def tree_columns(x0: int, z0: int, w: int, h: int, biome: np.ndarray,
                 slope: np.ndarray, height_y: np.ndarray,
                 water_y: np.ndarray, cfg: WorldConfig,
                 gs: WorldGenSettings) -> np.ndarray:
    """(w, h) bool mask of columns that host a tree.

    Gates per FloraPlacer.cs:18-74: forest biome, density hash, slope,
    above water, below snowline."""
    gx = np.arange(x0, x0 + w)[:, None] + np.zeros((1, h), np.int64)
    gz = np.arange(z0, z0 + h)[None, :] + np.zeros((w, 1), np.int64)
    r01 = hash_u32(gx, gz, cfg.seed + 901).astype(np.float64) / 4294967296.0
    mask = ((np.asarray(biome) == Biome.FOREST)
            & (r01 < gs.forest_tree_density)
            & (np.asarray(slope) <= gs.max_tree_slope)
            & (np.asarray(height_y) > np.asarray(water_y) + 1)
            & (np.asarray(height_y) < cfg.snow_level - 4))
    return mask


def tree_edits(gx: int, gz: int, surface_y: int, cfg: WorldConfig) -> List[Edit]:
    """Voxel edits for one tree at world column (gx, gz); conifer vs
    broadleaf per hash (FloraPlacer.cs canopy variants)."""
    h = int(hash_u32(np.int64(gx), np.int64(gz), cfg.seed + 977))
    conifer = (h & 1) == 1
    trunk_h = 4 + (h >> 1) % 3
    edits: List[Edit] = []
    top = surface_y + trunk_h
    for y in range(surface_y + 1, top + 1):
        edits.append((gx, y, gz, WOOD))
    if conifer:
        # Stacked shrinking rings (conifer canopy).
        r = 2
        for y in range(top - 1, top + 3):
            for dx in range(-r, r + 1):
                for dz in range(-r, r + 1):
                    if abs(dx) + abs(dz) <= r:
                        if dx == 0 and dz == 0 and y <= top:
                            continue
                        edits.append((gx + dx, y, gz + dz, LEAVES))
            r = max(0, r - 1)
    else:
        # 3x3x2 broadleaf blob + cap.
        for y in (top, top + 1):
            for dx in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    if dx == 0 and dz == 0 and y == top:
                        continue
                    edits.append((gx + dx, y, gz + dz, LEAVES))
        edits.append((gx, top + 2, gz, LEAVES))
    return edits


def place_trees_global(biome, slope, height_y, water_y, cfg: WorldConfig,
                       gs: WorldGenSettings) -> List[Edit]:
    """All tree edits for a whole (W, H) world heightfield
    (FloraPlacer.PlaceTreesGlobal)."""
    mask = tree_columns(0, 0, biome.shape[0], biome.shape[1], biome, slope,
                        height_y, water_y, cfg, gs)
    edits: List[Edit] = []
    xs, zs = np.where(mask)
    hy = np.asarray(height_y)
    for x, z in zip(xs, zs):
        edits.extend(tree_edits(int(x), int(z), int(hy[x, z]), cfg))
    return edits
