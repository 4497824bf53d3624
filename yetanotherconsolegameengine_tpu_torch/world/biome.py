"""Biome classification (Biome.cs:3-14, BiomeMap.cs:7-22)."""

from __future__ import annotations

import enum

import numpy as np

from .genmath import fbm2d, ridged_fbm2d
from .settings import WorldConfig, WorldGenSettings


class Biome(enum.IntEnum):
    """9-value biome enum (Biome.cs:3-14)."""

    OCEAN = 0
    BEACH = 1
    PLAINS = 2
    FOREST = 3
    DESERT = 4
    MOUNTAIN = 5
    SNOW = 6
    RIVER = 7
    LAKE = 8


def evaluate(x, z, height_y, water_y, cfg: WorldConfig,
             gs: WorldGenSettings) -> np.ndarray:
    """Vectorized BiomeMap.Evaluate: hard ocean/beach overrides, then
    moisture-vs-ridged-dryness threshold -> Desert/Forest, with
    mountain/snow elevation bands."""
    x = np.asarray(x)
    z = np.asarray(z)
    hy = np.asarray(height_y)
    wy = np.asarray(water_y)

    moisture = 0.5 + 0.5 * fbm2d(x * gs.moisture_freq, z * gs.moisture_freq,
                                 octaves=4, seed=cfg.seed + 601)
    dryness = ridged_fbm2d(x * gs.dryness_freq, z * gs.dryness_freq,
                           octaves=3, seed=cfg.seed + 701)

    biome = np.full(hy.shape, int(Biome.PLAINS), np.int32)
    biome[moisture > dryness + 0.05] = Biome.FOREST
    biome[dryness > moisture + 0.15] = Biome.DESERT
    biome[hy >= cfg.snow_level] = Biome.SNOW
    biome[(hy >= int(cfg.world_y * 0.6)) & (hy < cfg.snow_level)] = \
        Biome.MOUNTAIN
    # Hard overrides last (BiomeMap.cs:9-13).
    biome[hy <= wy + 2] = Biome.BEACH
    biome[hy <= wy] = Biome.OCEAN
    return biome
