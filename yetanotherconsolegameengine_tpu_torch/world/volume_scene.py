"""Voxel-world gameplay: streaming scene, player physics, day/night.

Port of ``yetanotherconsolegameengine_tpu/world/volume_scene.py``.
``VolumeScene`` streams chunks around the camera each update, runs
gravity/jump/fly player physics with ground probing, horizontal collision
with slide-along-wall, wall de-penetration and embedded-escape, all as
O(1) cell lookups in the streaming window's host mirror (physics never
touches the device), and returns the frame's ``SceneData``.

``DayNightEntity`` puts sun and moon point lights on a 2000-unit circle
with a quadratic sun intensity and a lerped sky gradient.

``build_minecraft_like`` generates and saves the island world (VG01) under
``tempfile.gettempdir()`` when absent, reloads it memory-mapped, streams
its chunks on the given device (the card unless "cpu" is given) and drops
the camera on the surface. By default the loaded chunks' surfaces trace as
cluster tables through kernel K3 on the card; ``surface_mesh=False``
traces the voxel window with the DDA instead.
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
from typing import Optional, Tuple

import numpy as np

import torch

from ..devices import resolve_device
from ..scene.materials import PROC_CELL_TINT
from ..scene.tables import SceneBuilder, SceneData
from ..scene.voxel_scenes import WATER, block_material
from . import worldgen
from .manager import WorldManager
from .persistence import WorldFile, save_world
from .settings import WorldConfig

# Player geometry/physics constants (VolumeScenes.cs:20-40).
GRAVITY = 9.81
EYE_HEIGHT = 1.62
PLAYER_RADIUS = 0.35
JUMP_SPEED = 5.0
WALK_SPEED = 4.5
FLY_MULT = 30.0

N_BLOCKS = 12
N_METAS = 5


def build_palette_lut(builder: SceneBuilder) -> np.ndarray:
    """Prewarm every (block, meta) material into the bank and return the
    (N_BLOCKS, N_METAS) bank-id LUT (VoxelMaterialPalette prewarm)."""
    lut = np.zeros((N_BLOCKS, N_METAS), np.int16)
    for b in range(1, N_BLOCKS):
        for m in range(N_METAS):
            lut[b, m] = builder.bank.add(block_material(b, m))
    return lut


class DayNightEntity:
    """Sun + moon on a 2000-unit circle (DayNightCycle.cs:10-114)."""

    def __init__(self, day_seconds: float = 120.0, radius: float = 2000.0):
        self.day_seconds = day_seconds
        self.radius = radius
        self.t = 0.25  # start mid-morning

    def update(self, dt: float):
        self.t = (self.t + dt / self.day_seconds) % 1.0

    def lights_and_sky(self, center) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray, np.ndarray,
                                              np.ndarray]:
        """Returns (light_pos (2,3), light_color (2,3), light_intensity (2,),
        bg_top (3,), bg_bottom (3,))."""
        ang = self.t * 2.0 * math.pi
        sun_dir = np.asarray([math.cos(ang), math.sin(ang), 0.15])
        sun_pos = np.asarray(center) + self.radius * sun_dir
        moon_pos = np.asarray(center) - self.radius * sun_dir
        sun_i = max(0.0, math.sin(ang))
        # Quadratic sun intensity, 300000 * sunI (DayNightCycle.cs).
        sun_int = 300000.0 * sun_i * sun_i
        moon_int = 25000.0 * max(0.0, -math.sin(ang))
        day_top = np.asarray([0.45, 0.68, 0.95])
        day_bot = np.asarray([0.85, 0.92, 1.0])
        night_top = np.asarray([0.02, 0.03, 0.08])
        night_bot = np.asarray([0.05, 0.06, 0.12])
        k = _smooth(sun_i)
        pos = np.stack([sun_pos, moon_pos]).astype(np.float32)
        col = np.asarray([[1.0, 0.96, 0.88], [0.6, 0.7, 0.95]], np.float32)
        inten = np.asarray([sun_int, moon_int], np.float32)
        top = (night_top + (day_top - night_top) * k).astype(np.float32)
        bot = (night_bot + (day_bot - night_bot) * k).astype(np.float32)
        return pos, col, inten, top, bot


def _smooth(x: float) -> float:
    x = min(1.0, max(0.0, x))
    return x * x * (3.0 - 2.0 * x)


class VolumeScene:
    """Streaming voxel world + player controller.

    Owns a WorldManager and a base SceneData; ``update`` streams chunks,
    advances physics and the day cycle, and returns the frame's SceneData
    (voxels + lights swapped in — no recompiles: all shapes static).
    """

    def __init__(self, base: SceneData, manager: WorldManager,
                 spawn: Tuple[float, float, float],
                 day_night: Optional[DayNightEntity] = None):
        self.base = base
        self.manager = manager
        self.day_night = day_night
        self.pos = np.asarray(spawn, np.float64)  # eye position
        self.vel = np.zeros(3)
        self.yaw = 0.0
        self.pitch = -0.2
        self.flying = False
        self.on_ground = False

    # -- physics (VolumeScenes.cs:94-158 Update; collision :219-440) --------

    def _solid(self, x, y, z) -> bool:
        return self.manager.sample_cell(x, y, z) != 0

    def _feet(self) -> float:
        return self.pos[1] - EYE_HEIGHT

    def _ground_probe(self) -> Optional[float]:
        """5-point ground fan (TrySampleGroundYFan, VolumeScenes.cs:478-518):
        center + 4 offsets at the player radius."""
        best = None
        for dx, dz in ((0, 0), (PLAYER_RADIUS, 0), (-PLAYER_RADIUS, 0),
                       (0, PLAYER_RADIUS), (0, -PLAYER_RADIUS)):
            g = self.manager.ground_height(self.pos[0] + dx,
                                           self.pos[2] + dz,
                                           self._feet() + 0.1)
            if g is not None and (best is None or g > best):
                best = g
        return best

    def _move_horizontal(self, delta: np.ndarray):
        """Micro-stepped horizontal move with slide-along-wall
        (AttemptMoveHorizontal, VolumeScenes.cs:219-279): probes at torso
        and eye heights; a blocked axis is cancelled independently."""
        dist = float(np.hypot(delta[0], delta[2]))
        if dist <= 1e-9:
            return
        steps = max(1, int(dist / 0.25))
        sub = delta / steps
        for _ in range(steps):
            for axis in (0, 2):
                if abs(sub[axis]) <= 1e-12:
                    continue
                nxt = self.pos.copy()
                nxt[axis] += sub[axis]
                lead = nxt.copy()
                lead[axis] += math.copysign(PLAYER_RADIUS, sub[axis])
                feet_y = nxt[1] - EYE_HEIGHT
                blocked = any(
                    self._solid(lead[0], y, lead[2])
                    for y in (feet_y + 0.2, feet_y + 1.0, nxt[1]))
                if not blocked:
                    self.pos[axis] = nxt[axis]

    def _resolve_embedded(self):
        """Pop the player up out of terrain (ResolveIfEmbedded,
        VolumeScenes.cs:328-380)."""
        for _ in range(8):
            feet = self._feet()
            if not (self._solid(self.pos[0], feet + 0.3, self.pos[2])
                    or self._solid(self.pos[0], self.pos[1], self.pos[2])):
                return
            self.pos[1] += 1.0

    def apply_input(self, forward: float, strafe: float, up: float,
                    jump: bool, sprint: bool, dt: float):
        """WASD-style intent in the camera frame; sprint = fly boost
        (Shift fly + 30x, VolumeScenes.cs)."""
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        speed = WALK_SPEED * (FLY_MULT if (self.flying and sprint) else 1.0)
        move = np.asarray([
            (sy * forward + cy * strafe) * speed * dt,
            0.0,
            (-cy * forward + sy * strafe) * speed * dt,
        ])
        if self.flying:
            self.pos += move
            self.pos[1] += up * speed * dt
            self.vel[:] = 0.0
        else:
            self._move_horizontal(move)
            if jump and self.on_ground:
                self.vel[1] = JUMP_SPEED
                self.on_ground = False

    def update(self, dt: float) -> SceneData:
        dt = min(dt, 0.1)
        self.manager.load_chunks_around(self.pos)
        self.manager.drain_ready()

        if not self.flying:
            self.vel[1] -= GRAVITY * dt
            self.pos[1] += self.vel[1] * dt
            ground = self._ground_probe()
            feet = self._feet()
            if ground is not None and feet <= ground + 1e-6:
                self.pos[1] = ground + EYE_HEIGHT
                self.vel[1] = 0.0
                self.on_ground = True
            else:
                self.on_ground = False
            self._resolve_embedded()
            # Fail-safe teleport when falling out of the world
            # (VolumeScenes.cs:152-158).
            if self.pos[1] < self.manager.cfg.world_min_y - 50.0:
                g = self.manager.ground_height(
                    self.pos[0], self.pos[2],
                    self.manager.cfg.world_y * self.manager.cfg.voxel_size)
                self.pos[1] = (g if g is not None else 80.0) + EYE_HEIGHT
                self.vel[:] = 0.0

        mc = self.manager.surface_clusters()
        if mc is not None:
            # Surface-mesh path (world/surface.py): the loaded chunks'
            # exposed faces trace on the cluster-matmul engine; the dense
            # voxel window stays host-side for physics only. Secondary
            # sweeps (sun/moon shadows, diffuse bounces) trace the pooled
            # coarse proxy.
            scene = dataclasses.replace(
                self.base, mesh_clusters=mc,
                mesh_clusters_lod=self.manager.surface_clusters_lod(),
                mesh_all_opaque=False)
        else:
            scene = dataclasses.replace(self.base,
                                        voxels=self.manager.voxel_world())
        if self.day_night is not None:
            self.day_night.update(dt)
            pos, col, inten, top, bot = self.day_night.lights_and_sky(
                self.pos)
            lights = self.base.lights
            L = lights.mask.shape[0]
            dev = scene.device
            if L >= 2:
                new = {}
                for f, v in (("pos", pos), ("color", col),
                             ("intensity", inten)):
                    new[f] = getattr(lights, f).clone()
                    new[f][:2] = _t(v, dev)
                lights = dataclasses.replace(lights, **new)
            scene = dataclasses.replace(scene, lights=lights,
                                        bg_top=_t(top, dev),
                                        bg_bottom=_t(bot, dev))
        return scene

    @property
    def camera(self) -> Tuple[Tuple[float, float, float], float, float]:
        return (tuple(self.pos), self.yaw, self.pitch)


def _t(x, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def build_minecraft_like(cfg: Optional[WorldConfig] = None,
                         world_path: Optional[str] = None,
                         day_seconds: float = 120.0,
                         regenerate: bool = False,
                         surface_mesh: bool = True,
                         device="cuda") -> VolumeScene:
    """Generate + save the island (VG01) if absent, reload memory-mapped,
    stream on ``device``, and spawn on the surface. Default world is
    256x128x256 voxels (8x4x8 chunks of 32), sized for terminal
    rendering."""
    cfg = cfg or WorldConfig(chunks_x=8, chunks_y=4, chunks_z=8,
                             view_distance=3)
    world_path = world_path or os.path.join(
        tempfile.gettempdir(), f"yacge_island_{cfg.seed}_"
        f"{cfg.world_x}x{cfg.world_y}x{cfg.world_z}.vg")
    if regenerate or not os.path.isfile(world_path):
        blocks, meta = worldgen.generate_world(cfg)
        save_world(world_path, blocks, meta)

    s = SceneBuilder("minecraft_like")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.35
    lut = build_palette_lut(s)
    # Two mutable slots for sun + moon.
    s.add_light((0.0, 1000.0, 0.0), (1, 1, 1), 1.0)
    s.add_light((0.0, -1000.0, 0.0), (1, 1, 1), 0.0)
    s.binary_shadows = True

    transparent_banks = merge_lut = None
    if surface_mesh:
        # One PROC_CELL_TINT surface material per block id: the mesher
        # merges faces across meta-variant bank ids (which would shatter
        # greedy rectangles ~10x) and shading restores the per-cell tint
        # from the hit cell's position hash.
        surf_id = np.zeros(N_BLOCKS, np.int16)
        for b in range(1, N_BLOCKS):
            m0 = block_material(b, 2)  # meta=2 is the unit-tint variant
            if b != WATER:             # water flats read better untinted
                m0 = dataclasses.replace(m0, proc=PROC_CELL_TINT,
                                         proc_scale=cfg.voxel_size)
            surf_id[b] = s.bank.add(m0)
        # Per-bank transparency gates the exposed-face rule (a sand face
        # exists under water; water-water faces don't).
        transparent_banks = np.asarray(
            [m.transparency > 0.0 for m in s.bank._mats], bool)
        merge_lut = np.zeros(len(s.bank._mats), np.int16)
        for b in range(1, N_BLOCKS):
            for mm in range(lut.shape[1]):
                merge_lut[lut[b, mm]] = surf_id[b]

    base = s.build().to(resolve_device(device))
    manager = WorldManager(cfg, lut, WorldFile(world_path),
                           transparent_banks=transparent_banks,
                           surface_merge_lut=merge_lut, device=device)
    # Spawn at world center on the surface.
    cx = cfg.world_x * cfg.voxel_size / 2
    cz = cfg.world_z * cfg.voxel_size / 2
    manager.ensure_all_loaded((cx, 0.0, cz))
    g = manager.ground_height(cx, cz, cfg.world_y * cfg.voxel_size)
    spawn_y = (g if g is not None else cfg.world_y * 0.5) + EYE_HEIGHT
    vs = VolumeScene(base, manager, (cx, spawn_y, cz),
                     DayNightEntity(day_seconds))
    return vs
