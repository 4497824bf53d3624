"""World configuration & generation tunables.

Parity with WorldConfig (ConsoleGame/RayTracing/Scenes/
WorldGeneration/WorldConfig.cs:3-35), IslandSettings (IslandSettings.cs)
and WorldGenSettings (WorldGenSettings.cs:8-172). Block id constants live
in scene/voxel_scenes.py (shared with the palette).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    """Chunk/world geometry (WorldConfig.cs:3-35)."""

    chunk_size: int = 32
    chunks_x: int = 32           # world = chunks_x * chunk_size voxels
    chunks_y: int = 8
    chunks_z: int = 32
    view_distance: int = 4       # chunks, horizontal radius
    world_min_y: float = 0.0
    voxel_size: float = 1.0
    seed: int = 1337

    @property
    def world_x(self) -> int:
        return self.chunks_x * self.chunk_size

    @property
    def world_y(self) -> int:
        return self.chunks_y * self.chunk_size

    @property
    def world_z(self) -> int:
        return self.chunks_z * self.chunk_size

    # Derived levels (WorldConfig.cs: WaterLevel = H/4, SnowLevel = 0.8H).
    @property
    def water_level(self) -> int:
        return self.world_y // 4

    @property
    def snow_level(self) -> int:
        return int(self.world_y * 0.8)


@dataclasses.dataclass(frozen=True)
class IslandSettings:
    """Island shaping tunables (IslandSettings.cs)."""

    island_radius: float = 10000.0     # 10 km
    coast_jitter: float = 0.15
    # Frequencies are island-relative: continent ~2.5 periods across the
    # island, mountains ~8, detail ~30 — smooth at any map resolution.
    warp_freq: float = 1.0 / 3500.0
    warp_amp: float = 600.0
    continent_freq: float = 1.0 / 8000.0
    mountain_freq: float = 1.0 / 2500.0
    detail_freq: float = 1.0 / 700.0
    terrace_step: float = 0.0          # 0 = off


@dataclasses.dataclass(frozen=True)
class WorldGenSettings:
    """Vegetation / strata / moisture tunables (WorldGenSettings.cs)."""

    forest_tree_density: float = 0.03  # FloraPlacer.cs:18
    tree_min_space: int = 2
    max_tree_slope: float = 0.35
    moisture_freq: float = 1.0 / 400.0
    dryness_freq: float = 1.0 / 550.0
    strata_freq: float = 1.0 / 60.0
    river_carve_depth: float = 6.0
    river_min_accum: float = 60.0
