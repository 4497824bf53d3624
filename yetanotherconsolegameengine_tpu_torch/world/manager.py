"""Chunk streaming engine (the reference's WorldManager).

Port of ``yetanotherconsolegameengine_tpu/world/manager.py``: desired-set
diffing around the camera with near-first radial ordering, background
worker threads with a stale-job bailout against the published desired set,
an LRU chunk cache, and chunk sources of either live generation or
memory-mapped VG01 reads.

The sink is a dense (Wx, Wy, Wz) int16 voxel window on the manager's
device (the card unless "cpu" is given), written in place one chunk at a
time. The window recenters with hysteresis when the camera nears its
edge; a host mirror makes recentering one re-upload and gives physics
O(1) cell queries. Workers produce numpy only: every device write happens
on the caller's thread, in ``drain_ready`` and the calls that follow it.
The DDA's distance encoding (ops/dda.py ``encode_cells``) is recomputed by
``voxel_world`` only when chunks changed. With a per-bank transparency
LUT the manager also meshes the loaded chunks' surfaces into cluster
tables (world/surface.py), full and pooled coarse.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..devices import resolve_device
from ..ops.dda import VoxelWorld, encode_cells
from .persistence import WorldFile
from .settings import WorldConfig
from .surface import SurfaceClusterTable, greedy_mesh_chunk, pool_cells

ChunkKey = Tuple[int, int, int]


class WorldManager:
    """Streams chunks from a source into a device voxel window.

    ``source``: a ``WorldFile`` (VG01 mapped reads) or a callable
    ``(cx, cy, cz) -> (blocks, meta)`` (live generation).
    ``block_lut``: (n_blocks, n_metas) int16 material-bank ids — the baked
    VoxelMaterialPalette, prewarmed).
    ``device``: where the window and the surface tables live.
    ``shutdown`` stops and joins the worker threads.
    """

    def __init__(self, cfg: WorldConfig, block_lut: np.ndarray, source,
                 n_workers: int = 4, cache_chunks: int = 512,
                 transparent_banks: Optional[np.ndarray] = None,
                 surface_merge_lut: Optional[np.ndarray] = None,
                 surface_cap_clusters: int = 1536, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.lut = np.asarray(block_lut, np.int16)
        self.source = source
        C = cfg.chunk_size
        self.window_cx = 2 * cfg.view_distance + 1
        self.window_cy = cfg.chunks_y
        wx = self.window_cx * C
        wy = self.window_cy * C
        # Window origin in chunk coords (x, z); hysteresis in voxels.
        self._wc: Optional[Tuple[int, int]] = None
        self._host = np.zeros((wx, wy, wx), np.int16)
        self._cells = torch.zeros((wx, wy, wx), dtype=torch.int16,
                                  device=self.device)
        self._enc: Optional[torch.Tensor] = None
        self._occ_dirty = True
        self._loaded: set = set()
        self._desired: set = set()
        self._desired_lock = threading.Lock()
        self._inflight: set = set()
        self._jobs: "queue.Queue[ChunkKey]" = queue.Queue()
        self._ready: "queue.Queue[Tuple[ChunkKey, np.ndarray]]" = queue.Queue()
        self._cache: "OrderedDict[ChunkKey, np.ndarray]" = OrderedDict()
        self._cache_cap = cache_chunks
        self._stop = threading.Event()
        self._workers = [threading.Thread(target=self._worker_loop,
                                          daemon=True)
                         for _ in range(max(1, n_workers))]
        for w in self._workers:
            w.start()
        self.stats: Dict[str, int] = dict(generated=0, cache_hits=0,
                                          uploads=0, recenters=0,
                                          stale_bailouts=0, remeshes=0)
        # Surface-mesh sink (world/surface.py): enabled when the caller
        # supplies the per-bank transparency LUT (needed for the exposed-
        # face rule). The dense window stays resident either way — physics
        # and the DDA parity path read it.
        self._surface: Optional[SurfaceClusterTable] = None
        if transparent_banks is not None:
            h = cfg.voxel_size
            wb = np.asarray([[0.0, 0.0, 0.0],
                             [cfg.world_x * h, cfg.world_y * h,
                              cfg.world_z * h]], np.float32)
            self._surface = SurfaceClusterTable(surface_cap_clusters, wb,
                                                device=self.device)
            self._transparent = np.asarray(transparent_banks, bool)
            self._surf_merge = (None if surface_merge_lut is None
                                else np.asarray(surface_merge_lut, np.int16))
            self._surf_dirty: set = set()
            # Coarse proxy for SECONDARY sweeps (shadow/bounce rays trace
            # ~1/16 the quads; t_bias absorbs the pooled surface's
            # deviation — same design as the hero-mesh LOD, scene/lod.py).
            self._lod_factor = 4
            # The interval cull tests every table row each sweep, so caps
            # are perf-relevant: the default island window peaks ~1.1k
            # full clusters / ~90 coarse (overflow is counted, not fatal).
            self._surface_lod = SurfaceClusterTable(
                max(64, surface_cap_clusters // 6), wb,
                t_bias=(self._lod_factor * 1.75) * cfg.voxel_size,
                device=self.device)

    # -- worker side ---------------------------------------------------------

    def _bake(self, blocks: np.ndarray, meta: np.ndarray) -> np.ndarray:
        """(block, meta) -> bank ids via the prewarmed palette LUT."""
        b = np.clip(blocks, 0, self.lut.shape[0] - 1)
        m = np.abs(meta) % self.lut.shape[1]
        return self.lut[b, m]

    def _produce(self, key: ChunkKey) -> np.ndarray:
        cx, cy, cz = key
        C = self.cfg.chunk_size
        if isinstance(self.source, WorldFile):
            blocks, meta = self.source.read_chunk(cx * C, cy * C, cz * C, C)
            if blocks.shape != (C, C, C):  # world edge: pad with air
                full_b = np.zeros((C, C, C), np.int32)
                full_m = np.zeros((C, C, C), np.int32)
                full_b[:blocks.shape[0], :blocks.shape[1],
                       :blocks.shape[2]] = blocks
                full_m[:meta.shape[0], :meta.shape[1], :meta.shape[2]] = meta
                blocks, meta = full_b, full_m
        else:
            blocks, meta = self.source(cx, cy, cz)
        self.stats["generated"] += 1
        return self._bake(blocks, meta)

    def _worker_loop(self):
        while not self._stop.is_set():
            try:
                key = self._jobs.get(timeout=0.05)
            except queue.Empty:
                continue
            with self._desired_lock:
                wanted = key in self._desired
            if not wanted:  # stale-job bailout (WorldManager.cs:906-911)
                self.stats["stale_bailouts"] += 1
                self._inflight.discard(key)
                continue
            try:
                cells = self._produce(key)
                self._ready.put((key, cells))
            except Exception:
                self._inflight.discard(key)

    # -- main-thread side ----------------------------------------------------

    def _camera_chunk(self, cam_pos) -> Tuple[int, int]:
        C = self.cfg.chunk_size
        return (int(np.floor(cam_pos[0] / C)), int(np.floor(cam_pos[2] / C)))

    def _window_origin_vox(self) -> Tuple[int, int, int]:
        C = self.cfg.chunk_size
        wcx, wcz = self._wc
        return ((wcx - self.cfg.view_distance) * C, 0,
                (wcz - self.cfg.view_distance) * C)

    def load_chunks_around(self, cam_pos) -> None:
        """Desired-set diff + job scheduling (LoadChunksAround)."""
        ccx, ccz = self._camera_chunk(cam_pos)
        if self._wc is None:
            self._wc = (ccx, ccz)
        elif max(abs(ccx - self._wc[0]), abs(ccz - self._wc[1])) >= 2:
            self._recenter((ccx, ccz))

        v = self.cfg.view_distance
        wcx, wcz = self._wc
        desired = set()
        for dx in range(-v, v + 1):
            for dz in range(-v, v + 1):
                cx, cz = wcx + dx, wcz + dz
                if not (0 <= cx < self.cfg.chunks_x
                        and 0 <= cz < self.cfg.chunks_z):
                    continue
                for cy in range(self.cfg.chunks_y):
                    desired.add((cx, cy, cz))
        with self._desired_lock:
            self._desired = desired

        to_add = sorted(
            desired - self._loaded - self._inflight,
            key=lambda k: (k[0] - ccx) ** 2 + (k[2] - ccz) ** 2)
        for key in to_add:
            cached = self._cache.pop(key, None)
            if cached is not None:  # TryAttachFromCache
                self.stats["cache_hits"] += 1
                self._ready.put((key, cached))
                self._inflight.add(key)
            else:
                self._inflight.add(key)
                self._jobs.put(key)
        for key in list(self._loaded - desired):
            self._evict(key)

    # -- surface-mesh sink ---------------------------------------------------

    def _neighbors(self, key: ChunkKey):
        cx, cy, cz = key
        for d in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                  (0, 0, 1), (0, 0, -1)):
            yield (cx + d[0], cy + d[1], cz + d[2])

    def _mark_surf_dirty(self, key: ChunkKey, with_neighbors: bool = True):
        """A chunk's mesh depends on its 1-cell shell: when it (or a
        neighbor) changes, boundary faces appear/disappear, so the chunk
        AND its loaded neighbors remesh. The dirty set dedups across a
        drain batch."""
        if self._surface is None:
            return
        self._surf_dirty.add(key)
        if with_neighbors:
            for nk in self._neighbors(key):
                if nk in self._loaded:
                    self._surf_dirty.add(nk)

    def _padded_cells(self, key: ChunkKey) -> Optional[np.ndarray]:
        """Chunk cells + 1-cell neighbor shell from the host mirror
        (0 = air outside the window)."""
        off = self._chunk_offset(key)
        if off is None:
            return None
        C = self.cfg.chunk_size
        x0, y0, z0 = off
        out = np.zeros((C + 2, C + 2, C + 2), np.int16)
        s = self._host.shape
        sl_src, sl_dst = [], []
        for o, n in ((x0, s[0]), (y0, s[1]), (z0, s[2])):
            lo = max(o - 1, 0)
            hi = min(o + C + 1, n)
            sl_src.append(slice(lo, hi))
            sl_dst.append(slice(lo - (o - 1), hi - (o - 1)))
        out[tuple(sl_dst)] = self._host[tuple(sl_src)]
        return out

    def _coarse_padded(self, key: ChunkKey) -> Optional[np.ndarray]:
        """Chunk region pooled by the LOD factor, with a 1-coarse-cell
        shell (pool the host mirror on demand; window edges read air)."""
        off = self._chunk_offset(key)
        if off is None:
            return None
        C = self.cfg.chunk_size
        f = self._lod_factor
        s = self._host.shape
        region = np.zeros((C + 2 * f,) * 3, np.int16)
        sl_src, sl_dst = [], []
        for o, n in zip(off, s):
            lo = max(o - f, 0)
            hi = min(o + C + f, n)
            sl_src.append(slice(lo, hi))
            sl_dst.append(slice(lo - (o - f), hi - (o - f)))
        region[tuple(sl_dst)] = self._host[tuple(sl_src)]
        return pool_cells(region, f, merge_lut=self._surf_merge)

    def _flush_surface(self):
        """Remesh every dirty chunk (full + coarse-LOD) and batch-scatter
        the cluster rows."""
        if self._surface is None or not self._surf_dirty:
            return
        C = self.cfg.chunk_size
        h = self.cfg.voxel_size
        f = self._lod_factor
        empty = (np.zeros((0, 3, 3), np.float32), np.zeros(0, np.int32))
        items = []
        items_lod = []
        for key in self._surf_dirty:
            if key not in self._loaded:
                items.append((key, *empty))
                items_lod.append((key, *empty))
                continue
            padded = self._padded_cells(key)
            if padded is None:
                continue
            tris, mats = greedy_mesh_chunk(
                padded, self._transparent,
                (key[0] * C, key[1] * C, key[2] * C), h,
                merge_lut=self._surf_merge)
            items.append((key, tris, mats))
            # Coarse cells already carry merged ids (pool_cells applies
            # the LUT), and merged ids are themselves bank ids, so the
            # transparency LUT indexes them directly.
            coarse = self._coarse_padded(key)
            ctris, cmats = greedy_mesh_chunk(
                coarse, self._transparent,
                (key[0] * C // f, key[1] * C // f, key[2] * C // f),
                h * f)
            items_lod.append((key, ctris, cmats))
            self.stats["remeshes"] += 1
        self._surf_dirty.clear()
        self._surface.update_chunks(items)
        self._surface_lod.update_chunks(items_lod)

    def surface_clusters(self):
        """Device MeshClusters over every loaded chunk's exposed surface
        (None when surface meshing is off)."""
        if self._surface is None:
            return None
        self._flush_surface()
        return self._surface.clusters()

    def surface_clusters_lod(self):
        """Coarse proxy cluster set for secondary sweeps (None when
        surface meshing is off)."""
        if self._surface is None:
            return None
        self._flush_surface()
        return self._surface_lod.clusters()

    def _evict(self, key: ChunkKey):
        """Detach + LRU-cache a chunk (CacheChunk, WorldManager.cs:1107+)."""
        self._loaded.discard(key)
        self._mark_surf_dirty(key)
        sl = self._chunk_slice(key)
        if sl is not None:
            self._cache[key] = self._host[sl].copy()
            self._cache.move_to_end(key)
            while len(self._cache) > self._cache_cap:
                self._cache.popitem(last=False)
            self._host[sl] = 0
            self._cells[sl] = 0
            self._occ_dirty = True

    def _chunk_offset(self, key: ChunkKey) -> Optional[Tuple[int, int, int]]:
        ox, _, oz = self._window_origin_vox()
        C = self.cfg.chunk_size
        x0 = key[0] * C - ox
        y0 = key[1] * C
        z0 = key[2] * C - oz
        wx = self.window_cx * C
        if not (0 <= x0 < wx and 0 <= z0 < wx):
            return None
        return (x0, y0, z0)

    def _chunk_slice(self, key: ChunkKey):
        off = self._chunk_offset(key)
        if off is None:
            return None
        C = self.cfg.chunk_size
        x0, y0, z0 = off
        return (slice(x0, x0 + C), slice(y0, y0 + C), slice(z0, z0 + C))

    def _recenter(self, new_wc: Tuple[int, int]):
        """Shift the window: evict out-of-window chunks to cache, shift the
        host mirror, and re-upload once."""
        self.stats["recenters"] += 1
        C = self.cfg.chunk_size
        dx = (new_wc[0] - self._wc[0]) * C
        dz = (new_wc[1] - self._wc[1]) * C
        for key in list(self._loaded):
            off_x = key[0] * C - (new_wc[0] - self.cfg.view_distance) * C
            off_z = key[2] * C - (new_wc[1] - self.cfg.view_distance) * C
            wx = self.window_cx * C
            if not (0 <= off_x < wx and 0 <= off_z < wx):
                self._evict(key)
        shifted = np.zeros_like(self._host)
        src_x = slice(max(0, dx), self._host.shape[0] + min(0, dx))
        dst_x = slice(max(0, -dx), self._host.shape[0] + min(0, -dx))
        src_z = slice(max(0, dz), self._host.shape[2] + min(0, dz))
        dst_z = slice(max(0, -dz), self._host.shape[2] + min(0, -dz))
        shifted[dst_x, :, dst_z] = self._host[src_x, :, src_z]
        self._host = shifted
        self._wc = new_wc
        self._cells = torch.from_numpy(self._host.copy()).to(self.device)
        self._occ_dirty = True

    def drain_ready(self, max_chunks: int = 8) -> int:
        """Apply up to N finished chunks per frame (DrainReadyResults)."""
        applied = 0
        while applied < max_chunks:
            try:
                key, cells = self._ready.get_nowait()
            except queue.Empty:
                break
            self._inflight.discard(key)
            with self._desired_lock:
                wanted = key in self._desired
            off = self._chunk_offset(key) if wanted else None
            if off is None:
                self._cache[key] = cells  # keep for later
                continue
            sl = self._chunk_slice(key)
            self._host[sl] = cells
            self._cells[sl] = torch.from_numpy(cells).to(self.device)
            self._loaded.add(key)
            self._occ_dirty = True
            self._mark_surf_dirty(key)
            self.stats["uploads"] += 1
            applied += 1
        return applied

    def voxel_world(self) -> VoxelWorld:
        """Current device window as a DDA-ready VoxelWorld."""
        if self._occ_dirty:
            self._enc = encode_cells(self._cells)
            self._occ_dirty = False
        ox, oy, oz = self._window_origin_vox()
        h = self.cfg.voxel_size
        origin = torch.tensor([ox * h, oy * h, oz * h], dtype=torch.float32,
                              device=self.device)
        return VoxelWorld(cells=self._enc, origin=origin,
                          voxel_size=torch.tensor(h, dtype=torch.float32,
                                                  device=self.device))

    # -- physics / gameplay queries (host mirror) ----------------------------

    def sample_cell(self, x: float, y: float, z: float) -> int:
        """Bank id at a world position, 0 outside the window."""
        ox, oy, oz = self._window_origin_vox()
        h = self.cfg.voxel_size
        ix = int(np.floor(x / h)) - ox
        iy = int(np.floor(y / h)) - oy
        iz = int(np.floor(z / h)) - oz
        s = self._host.shape
        if 0 <= ix < s[0] and 0 <= iy < s[1] and 0 <= iz < s[2]:
            return int(self._host[ix, iy, iz])
        return 0

    def ground_height(self, x: float, z: float,
                      from_y: float) -> Optional[float]:
        """Highest solid cell top at column (x, z) at or below from_y."""
        ox, oy, oz = self._window_origin_vox()
        h = self.cfg.voxel_size
        ix = int(np.floor(x / h)) - ox
        iz = int(np.floor(z / h)) - oz
        s = self._host.shape
        if not (0 <= ix < s[0] and 0 <= iz < s[2]):
            return None
        top = min(s[1] - 1, int(np.floor(from_y / h)) - oy)
        col = self._host[ix, :top + 1, iz]
        solid = np.nonzero(col)[0]
        if len(solid) == 0:
            return None
        return float((oy + solid[-1] + 1) * h)

    def ensure_all_loaded(self, cam_pos, timeout: float = 60.0) -> None:
        """Block until the desired set is fully resident
        (EnsureAllChunksLoaded)."""
        self.load_chunks_around(cam_pos)
        t0 = time.time()
        while time.time() - t0 < timeout:
            self.drain_ready(max_chunks=64)
            with self._desired_lock:
                done = self._desired <= self._loaded
            if done:
                return
            time.sleep(0.005)
        raise TimeoutError("chunk streaming did not settle")

    def shutdown(self, timeout: float = 10.0):
        """Stop the workers and join them; raises if one is still running
        after ``timeout`` seconds."""
        self._stop.set()
        for w in self._workers:
            w.join(timeout=timeout)
        alive = sum(w.is_alive() for w in self._workers)
        if alive:
            raise RuntimeError(f"{alive} chunk worker(s) did not stop")
