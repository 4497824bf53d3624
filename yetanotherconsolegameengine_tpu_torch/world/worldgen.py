"""World generation pipeline (WorldGenerator, ConsoleGame/
RayTracing/Scenes/WorldGeneration/WorldGenerator.cs:95-203, and the
3-pass global generation of WorldManager.GenerateAndSaveWorld,
WorldManager.cs:510-631).

Per-column pipeline parity: heights -> river carve -> slope -> biome ->
water level -> voxel strata fill -> flora. The global variant runs rivers
over the whole heightfield (RiverNetworkGlobal); the per-chunk variant
(``generate_chunk_cells``) skips the global river pass exactly like the
reference's chunk-local path, so streamed chunks match the saved world
except carved rivers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..scene.voxel_scenes import AIR, WATER
from . import biome as biome_mod
from . import flora, layering, rivers, terrain
from .settings import IslandSettings, WorldConfig, WorldGenSettings


def _column_fields(gx: np.ndarray, gz: np.ndarray, cfg: WorldConfig,
                   isl: IslandSettings, gs: WorldGenSettings,
                   carve_rivers: bool, chunk_carve=None):
    """Shared column-level fields for a grid of world columns.

    gx/gz: (W, H) world-space voxel coordinates (centered on the island).
    ``chunk_carve``: optional (carve_depth, river_water_y) from the
    chunk-local river pass (rivers.compute_for_chunk) applied instead of
    the global carve."""
    hy = terrain.height_y(gx, gz, cfg, isl).astype(np.float64)
    river_mask = np.zeros(hy.shape, bool)
    river_water = None
    if carve_rivers:
        hy, river_mask, _ = rivers.carve(hy, gs)
    elif chunk_carve is not None:
        depth, river_water = chunk_carve
        hy = hy - np.floor(depth)
        river_mask = depth > 0.0
    hy = np.clip(hy, 1, cfg.world_y - 2).astype(np.int64)
    slope = terrain.slope01(gx, gz, cfg, isl)
    wy = terrain.local_water_y(gx, gz, cfg, isl)
    # River columns carry water at their carved surface.
    if river_water is not None:
        wy = np.where(river_mask, np.maximum(wy, river_water), wy)
    else:
        wy = np.where(river_mask, np.maximum(wy, hy + 1), wy)
    bio = biome_mod.evaluate(gx, gz, hy, wy, cfg, gs)
    return hy, wy, slope, bio


def fill_columns(hy, wy, slope, bio, gx, gz, cfg: WorldConfig,
                 gs: WorldGenSettings) -> Tuple[np.ndarray, np.ndarray]:
    """Voxel strata fill for a (W, H) column grid -> (W, Y, H) blocks+meta
    (WorldGenerator.GenerateChunkCells strata pass)."""
    W, H = hy.shape
    Y = cfg.world_y
    yy = np.arange(Y)[None, :, None]                     # (1, Y, 1)
    hy3 = np.asarray(hy)[:, None, :]                     # (W, 1, H)
    wy3 = np.asarray(wy)[:, None, :]

    surface = layering.choose_surface_block(bio, hy, slope, cfg)[:, None, :]
    depth = hy3 - yy
    sub = layering.subsurface_block(depth)

    below = yy < hy3
    blocks = np.where(below, sub, AIR)
    at_surface = yy == hy3
    blocks = np.where(at_surface, surface, blocks)
    water = (yy > hy3) & (yy <= wy3)
    blocks = np.where(water, WATER, blocks)

    meta = np.zeros((W, Y, H), np.int32)
    stone_like = below
    gx3 = np.broadcast_to(np.asarray(gx)[:, None, :], blocks.shape)
    gz3 = np.broadcast_to(np.asarray(gz)[:, None, :], blocks.shape)
    yy3 = np.broadcast_to(yy, blocks.shape)
    meta_band = layering.rock_meta_at(gx3, yy3, gz3, cfg, gs)
    meta = np.where(stone_like, meta_band, 0)
    return blocks.astype(np.int32), meta.astype(np.int32)


def generate_world(cfg: WorldConfig,
                   isl: IslandSettings = IslandSettings(),
                   gs: WorldGenSettings = WorldGenSettings(),
                   progress=None) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-world 3-pass generation (WorldManager.GenerateAndSaveWorld):
    pass 1 column fields + global rivers, pass 2 strata fill, pass 3 flora.
    Returns (blocks, meta) as (X, Y, Z) int32 arrays."""
    W, H = cfg.world_x, cfg.world_z
    # Island-centered world coordinates scaled so the island spans the map.
    scale = (2.2 * isl.island_radius) / max(W, H)
    gx = (np.arange(W)[:, None] - W / 2) * scale + np.zeros((1, H))
    gz = (np.arange(H)[None, :] - H / 2) * scale + np.zeros((W, 1))

    if progress:
        progress("pass 1/3: columns + rivers")
    hy, wy, slope, bio = _column_fields(gx, gz, cfg, isl, gs,
                                        carve_rivers=True)
    if progress:
        progress("pass 2/3: strata fill")
    blocks, meta = fill_columns(hy, wy, slope, bio, gx, gz, cfg, gs)
    if progress:
        progress("pass 3/3: flora")
    for (x, y, z, b) in flora.place_trees_global(bio, slope, hy, wy, cfg, gs):
        if 0 <= x < W and 0 <= y < cfg.world_y and 0 <= z < H:
            if blocks[x, y, z] == AIR:
                blocks[x, y, z] = b
    return blocks, meta


def generate_chunk_cells(cx: int, cy: int, cz: int, cfg: WorldConfig,
                         isl: IslandSettings = IslandSettings(),
                         gs: WorldGenSettings = WorldGenSettings()
                         ) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Single-chunk generation (WorldGenerator.GenerateChunkCells,
    WorldGenerator.cs:95-203): the same column pipeline with CHUNK-LOCAL
    rivers (RiverNetwork.ComputeForChunk) — D8 directions from global
    heights via the halo, accumulation restricted to the chunk, so
    live-streamed worlds get approximate local rivers exactly like the
    reference's unsaved path. Returns (blocks, meta, any_solid)."""
    C = cfg.chunk_size
    W, H = cfg.world_x, cfg.world_z
    scale = (2.2 * isl.island_radius) / max(W, H)
    xs = np.arange(cx * C, (cx + 1) * C)
    zs = np.arange(cz * C, (cz + 1) * C)
    gx = (xs[:, None] - W / 2) * scale + np.zeros((1, C))
    gz = (zs[None, :] - H / 2) * scale + np.zeros((C, 1))
    # Chunk-local river pass over a 1-cell height halo.
    xs_r = np.arange(cx * C - 1, (cx + 1) * C + 1)
    zs_r = np.arange(cz * C - 1, (cz + 1) * C + 1)
    gxr = (xs_r[:, None] - W / 2) * scale + np.zeros((1, len(zs_r)))
    gzr = (zs_r[None, :] - H / 2) * scale + np.zeros((len(xs_r), 1))
    hy_halo = terrain.height_y(gxr, gzr, cfg, isl).astype(np.float64)
    chunk_carve = rivers.compute_for_chunk(hy_halo, 1, gs,
                                           float(cfg.water_level))
    hy, wy, slope, bio = _column_fields(gx, gz, cfg, isl, gs,
                                        carve_rivers=False,
                                        chunk_carve=chunk_carve)
    blocks, meta = fill_columns(hy, wy, slope, bio, gx, gz, cfg, gs)
    y0 = cy * C
    cb = blocks[:, y0:y0 + C, :]
    cm = meta[:, y0:y0 + C, :]
    # Flora overlapping this chunk: consider tree columns in a 2-cell halo.
    pad = 2
    xs_h = np.arange(cx * C - pad, (cx + 1) * C + pad)
    zs_h = np.arange(cz * C - pad, (cz + 1) * C + pad)
    gxh = (xs_h[:, None] - W / 2) * scale + np.zeros((1, len(zs_h)))
    gzh = (zs_h[None, :] - H / 2) * scale + np.zeros((len(xs_h), 1))
    hyh, wyh, sloh, bioh = _column_fields(gxh, gzh, cfg, isl, gs,
                                          carve_rivers=False)
    mask = flora.tree_columns(int(xs_h[0]), int(zs_h[0]), len(xs_h),
                              len(zs_h), bioh, sloh, hyh, wyh, cfg, gs)
    for i, j in zip(*np.where(mask)):
        wx_col = int(xs_h[i])
        wz_col = int(zs_h[j])
        for (x, y, z, b) in flora.tree_edits(wx_col, wz_col,
                                             int(hyh[i, j]), cfg):
            lx, ly, lz = x - cx * C, y - y0, z - cz * C
            if 0 <= lx < C and 0 <= ly < C and 0 <= lz < C:
                if cb[lx, ly, lz] == AIR:
                    cb[lx, ly, lz] = b
    return cb.copy(), cm.copy(), bool((cb != AIR).any())
