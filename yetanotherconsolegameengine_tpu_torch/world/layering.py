"""Block layering + rock strata (Layering.cs:7-45, StrataMap.cs:8).

Column fill rules: surface block by biome/snowline/slope, dirt subsurface,
stone core with meta banding for visual variety.
"""

from __future__ import annotations

import numpy as np

from ..scene.voxel_scenes import (DIRT, GRASS, SAND, SNOW, STONE)
from .biome import Biome
from .genmath import fbm2d
from .settings import WorldConfig, WorldGenSettings


def choose_surface_block(biome, height_y, slope, cfg: WorldConfig) -> np.ndarray:
    """Vectorized Layering.ChooseSurfaceBlock: snow above snowline, sand at
    beach/desert, stone on steep slope, grass default (Layering.cs:7-28)."""
    b = np.asarray(biome)
    hy = np.asarray(height_y)
    sl = np.asarray(slope)
    out = np.full(b.shape, GRASS, np.int32)
    out[(b == Biome.DESERT) | (b == Biome.BEACH) | (b == Biome.OCEAN)] = SAND
    out[sl > 0.55] = STONE
    out[(hy >= cfg.snow_level) | (b == Biome.SNOW)] = SNOW
    return out


def subsurface_block(depth: np.ndarray) -> np.ndarray:
    """Dirt for the first 3 voxels below the surface, stone deeper
    (Layering.cs:30-45)."""
    return np.where(np.asarray(depth) <= 3, DIRT, STONE).astype(np.int32)


def rock_meta_at(x, y, z, cfg: WorldConfig, gs: WorldGenSettings) -> np.ndarray:
    """Strata meta banding (StrataMap.RockMetaAt): horizontal noise bands
    drifting with depth give stone its layered look."""
    band = fbm2d(np.asarray(x) * gs.strata_freq,
                 (np.asarray(z) + np.asarray(y) * 3.0) * gs.strata_freq,
                 octaves=2, seed=cfg.seed + 811)
    return ((band * 0.5 + 0.5) * 5.0).astype(np.int32) % 5
