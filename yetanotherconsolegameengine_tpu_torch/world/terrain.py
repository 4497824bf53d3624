"""Island heightfield (TerrainNoise, ConsoleGame/RayTracing/
Scenes/WorldGeneration/TerrainNoise.cs:8-158).

Pipeline parity: two-stage domain warp -> ridged continent + mountain noise
blended with detail FBM -> optional terraces -> shoreline island-mask
clamp. All functions take (..., ) world-space x/z arrays.
"""

from __future__ import annotations

import numpy as np

from .genmath import fbm2d, gradient_noise_2d, ridged_fbm2d, saturate, smoothstep
from .settings import IslandSettings, WorldConfig


def domain_warp(x, z, s: IslandSettings, seed: int):
    """Two-stage domain warp (TerrainNoise.cs warp passes)."""
    wx1 = gradient_noise_2d(x * s.warp_freq, z * s.warp_freq, seed + 11)
    wz1 = gradient_noise_2d(x * s.warp_freq, z * s.warp_freq, seed + 23)
    x1 = x + s.warp_amp * wx1
    z1 = z + s.warp_amp * wz1
    f2 = s.warp_freq * 2.7
    wx2 = gradient_noise_2d(x1 * f2, z1 * f2, seed + 37)
    wz2 = gradient_noise_2d(x1 * f2, z1 * f2, seed + 41)
    return x1 + 0.35 * s.warp_amp * wx2, z1 + 0.35 * s.warp_amp * wz2


def island_mask01(x, z, s: IslandSettings, seed: int) -> np.ndarray:
    """Radial island falloff with coast jitter (TerrainNoise.IslandMask01)."""
    r = np.sqrt(np.asarray(x) ** 2 + np.asarray(z) ** 2)
    jitter = fbm2d(x * (1.0 / 1500.0), z * (1.0 / 1500.0), octaves=3,
                   seed=seed + 301)
    r_eff = r * (1.0 + s.coast_jitter * jitter)
    return 1.0 - smoothstep(0.72 * s.island_radius, s.island_radius, r_eff)


def height01(x, z, s: IslandSettings, seed: int) -> np.ndarray:
    """Normalized terrain height in [0, 1] (TerrainNoise.Height01)."""
    wx, wz = domain_warp(x, z, s, seed)
    continent = ridged_fbm2d(wx * s.continent_freq, wz * s.continent_freq,
                             octaves=4, seed=seed + 101)
    mountain = ridged_fbm2d(wx * s.mountain_freq, wz * s.mountain_freq,
                            octaves=5, seed=seed + 211)
    detail = 0.5 + 0.5 * fbm2d(wx * s.detail_freq, wz * s.detail_freq,
                               octaves=4, seed=seed + 401)
    h = 0.55 * continent + 0.35 * mountain * continent + 0.10 * detail
    if s.terrace_step > 0.0:
        h = np.floor(h / s.terrace_step) * s.terrace_step
    mask = island_mask01(x, z, s, seed)
    # Shoreline clamp: outside the island the floor sinks below water.
    return saturate(h * mask)


def height_y(x, z, cfg: WorldConfig, s: IslandSettings) -> np.ndarray:
    """World-space column height in voxels (TerrainNoise.HeightY)."""
    h01 = height01(x, z, s, cfg.seed)
    return np.clip((h01 * (cfg.world_y - 2)).astype(np.int64) + 1,
                   1, cfg.world_y - 2)


def slope01(x, z, cfg: WorldConfig, s: IslandSettings,
            delta: float = 2.0) -> np.ndarray:
    """Normalized local slope from central differences
    (TerrainNoise.Slope01At)."""
    hx1 = height01(x + delta, z, s, cfg.seed)
    hx0 = height01(x - delta, z, s, cfg.seed)
    hz1 = height01(x, z + delta, s, cfg.seed)
    hz0 = height01(x, z - delta, s, cfg.seed)
    g = np.sqrt((hx1 - hx0) ** 2 + (hz1 - hz0) ** 2) * (cfg.world_y
                                                        / (2.0 * delta))
    return saturate(g / 12.0)


def local_water_y(x, z, cfg: WorldConfig, s: IslandSettings) -> np.ndarray:
    """Per-column water surface: sea level, raised in lake basins
    (TerrainNoise.LocalWaterY)."""
    lake = fbm2d(np.asarray(x) * (1.0 / 1100.0),
                 np.asarray(z) * (1.0 / 1100.0), octaves=3,
                 seed=cfg.seed + 501)
    lakes = smoothstep(0.55, 0.8, lake) * 6.0
    return (cfg.water_level + lakes).astype(np.int64)
