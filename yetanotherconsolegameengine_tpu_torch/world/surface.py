"""Streamed-world surface meshing onto the cluster tables.

Port of ``yetanotherconsolegameengine_tpu/world/surface.py``. The streamed
world renders the surface of its voxels, not their volume:

  1. Each loaded chunk is greedy-meshed on the host (numpy, copied from
     the JAX module) into axis-aligned quads: exposed faces merged into
     runs along one axis, runs merged into rectangles along the other. A
     cell face is exposed against air, or against a transparent neighbour
     of another block (a sand face exists under water; water-water
     interior faces do not).
  2. The quads, as triangle pairs, are packed into KC-wide cluster blocks
     (ops/mesh_clusters.pack_cluster_blocks) and written into
     fixed-capacity tables on the table's device, by free-list slot
     allocation: a chunk arriving or leaving touches only its own rows,
     and the table shapes never change.
  3. The renderer traces the resulting ``MeshClusters`` like any cluster
     mesh, through kernel K3 on the card.

An axis-aligned quad hit is the cell's entry face, so normals, materials
and hit distances agree with the DDA path (ops/dda.py) on opaque grids.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..devices import resolve_device
from ..ops.mesh_clusters import KC, MeshClusters, pack_cluster_blocks

ChunkKey = Tuple[int, int, int]

# (layer_axis -> (u_axis, v_axis)) after moveaxis(ax, 0): remaining axes
# keep their original relative order.
_UV_AXES = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


def greedy_mesh_chunk(padded: np.ndarray, transparent: np.ndarray,
                      cell_origin: Sequence[int], voxel_size: float,
                      merge_lut: Optional[np.ndarray] = None):
    """Greedy-rectangle surface mesh of one chunk.

    ``padded``: (C+2, C+2, C+2) int16 bank ids — the chunk plus a 1-cell
    neighbor shell (0 = air outside the loaded window). ``transparent``:
    (n_banks,) bool, True where the bank material refracts.
    ``cell_origin``: the chunk's absolute min-corner cell coordinates.
    ``merge_lut``: optional (n_banks,) int32 bank -> emitted-material id.
    Per-cell meta-variant bank ids shatter greedy rectangles ~10x, so the
    streamed world merges on the BLOCK's surface material (one id per
    block, PROC_CELL_TINT restoring the per-cell variation in shading);
    identity when None.

    Returns (tris (T, 3, 3) float32 world-space, mats (T,) int32).
    Every exposed face is covered by exactly one quad.
    """
    C = padded.shape[0] - 2
    core = padded[1:-1, 1:-1, 1:-1]
    if not core.any():
        return (np.zeros((0, 3, 3), np.float32), np.zeros(0, np.int32))
    nbank = int(padded.max()) + 1
    tl = np.zeros(nbank, bool)
    n = min(len(tl), len(transparent))
    tl[:n] = transparent[:n]
    if merge_lut is None:
        mlut = np.arange(nbank, dtype=np.int16)
    else:
        mlut = np.zeros(nbank, np.int16)
        n = min(nbank, len(merge_lut))
        mlut[:n] = merge_lut[:n]
        mlut[0] = 0   # air must stay air regardless of the caller's LUT
    core_m = mlut[core]   # merged-material field (0 stays 0: mlut[0]=0)

    all_corners: List[np.ndarray] = []
    all_mats: List[np.ndarray] = []
    idx_v = np.arange(C)[None, None, :]

    for ax in range(3):
        for sgn in (1, -1):
            sl = [slice(1, -1)] * 3
            sl[ax] = slice(2, None) if sgn > 0 else slice(0, -2)
            nb = padded[tuple(sl)]
            exposed = (core > 0) & ((nb == 0)
                                    | (tl[nb] & (mlut[nb] != core_m)))
            if not exposed.any():
                continue
            m = np.moveaxis(exposed, ax, 0)        # (C, U, V)
            key = np.where(m, np.moveaxis(core_m, ax, 0), 0)

            # Runs along V: a run breaks on exposure or material change.
            prev = np.zeros_like(key)
            prev[:, :, 1:] = key[:, :, :-1]
            start = m & (key != prev)
            nxt = np.zeros_like(key)
            nxt[:, :, :-1] = key[:, :, 1:]
            end = m & (key != nxt)
            # Per-cell run end index (propagate each end backward).
            x1 = np.flip(np.minimum.accumulate(
                np.flip(np.where(end, idx_v, C), axis=2), axis=2), axis=2)

            # Merge identical runs (same v-start implied, same v-end, same
            # material) along U into rectangles.
            same_above = np.zeros_like(start)
            same_above[:, 1:, :] = (start[:, 1:, :] & start[:, :-1, :]
                                    & (x1[:, 1:, :] == x1[:, :-1, :])
                                    & (key[:, 1:, :] == key[:, :-1, :]))
            group_start = start & ~same_above
            # h[u] = merged-row count for a run starting at row u.
            h = np.zeros((C, C, C), np.int32)
            h[:, C - 1, :] = start[:, C - 1, :]
            for u in range(C - 2, -1, -1):
                h[:, u, :] = np.where(
                    start[:, u, :],
                    1 + np.where(same_above[:, u + 1, :], h[:, u + 1, :], 0),
                    0)

            ls, us, vs = np.nonzero(group_start)
            if ls.size == 0:
                continue
            v1 = x1[ls, us, vs] + 1
            u1 = us + h[ls, us, vs]
            mats = key[ls, us, vs].astype(np.int32)
            w = ls + (1 if sgn > 0 else 0)

            u_ax, v_ax = _UV_AXES[ax]
            q = np.zeros((ls.size, 4, 3), np.float32)
            # Corner order: (u0,v0) (u1,v0) (u1,v1) (u0,v1).
            q[:, :, ax] = w[:, None]
            q[:, 0, u_ax] = us;  q[:, 0, v_ax] = vs
            q[:, 1, u_ax] = u1;  q[:, 1, v_ax] = vs
            q[:, 2, u_ax] = u1;  q[:, 2, v_ax] = v1
            q[:, 3, u_ax] = us;  q[:, 3, v_ax] = v1
            all_corners.append(q)
            all_mats.append(mats)

    if not all_corners:
        return (np.zeros((0, 3, 3), np.float32), np.zeros(0, np.int32))
    q = np.concatenate(all_corners)
    mats = np.concatenate(all_mats)
    q += np.asarray(cell_origin, np.float32)[None, None, :]
    q *= np.float32(voxel_size)
    tris = np.concatenate([q[:, (0, 1, 2)], q[:, (0, 2, 3)]])
    return tris, np.concatenate([mats, mats])


def pool_cells(region: np.ndarray, factor: int,
               merge_lut: Optional[np.ndarray] = None,
               min_solid_frac: float = 0.125) -> np.ndarray:
    """Majority-pool a cell region to a coarse occupancy/material grid
    (the streamed world's secondary-ray LOD — same role as scene/lod.py's
    vertex clustering for hero meshes).

    A coarse cell is solid when >= ``min_solid_frac`` of its sub-cells
    are (1/8 by default: thin features like tree canopies survive, and
    the proxy's surface deviation is bounded by the coarse cell size,
    absorbed by the cluster set's t_bias). Its material is the modal
    merged id among solid sub-cells — sufficient for the only things
    secondary sweeps read: occlusion and approximate bounce albedo.
    """
    f = factor
    s = region.shape
    assert all(x % f == 0 for x in s)
    sub = region.reshape(s[0] // f, f, s[1] // f, f, s[2] // f, f)
    sub = sub.transpose(0, 2, 4, 1, 3, 5).reshape(
        s[0] // f, s[1] // f, s[2] // f, f * f * f)
    if merge_lut is not None:
        m = np.asarray(merge_lut)[sub]
    else:
        m = sub
    solid = m > 0
    occupied = solid.sum(-1) >= max(1, int(min_solid_frac * f * f * f))
    ids = np.unique(m[solid]) if occupied.any() else np.array([], m.dtype)
    if ids.size == 0:
        return np.zeros(sub.shape[:3], np.int16)
    counts = np.stack([(m == i).sum(-1) for i in ids])
    mode = ids[np.argmax(counts, axis=0)]
    return np.where(occupied, mode, 0).astype(np.int16)


class SurfaceClusterTable:
    """Fixed-capacity cluster tables with per-chunk slot streaming, on an
    explicit device (the card unless "cpu" is given).

    Chunks own disjoint sets of cluster rows (a free-list allocation: rows
    need no contiguity because the cull treats clusters independently).
    Updating or evicting a chunk writes only its rows, one indexed copy
    per table per batch. A free row has degenerate bounds (cbmin 1e30,
    cbmax -1e30), which the interval cull rejects for every ray, and its
    affine Woop rows start at -1 (never a valid barycentric), so stale
    ``gmat``/``tri_rows`` content is unreachable. The rows and the slot
    order equal the JAX package's tables (its gmat through
    ``gmat_from_jax``). ``clusters()`` returns the live tables: a later
    update writes into them.
    """

    def __init__(self, cap_clusters: int, world_bounds: np.ndarray,
                 t_bias: float = 0.0, device="cuda"):
        dev = resolve_device(device)
        self.cap = int(cap_clusters)
        self.t_bias = float(t_bias)
        self._cbmin = torch.full((self.cap, 3), 1e30, device=dev)
        self._cbmax = torch.full((self.cap, 3), -1e30, device=dev)
        self._gmat = torch.zeros((self.cap, 12, KC), device=dev)
        self._gmat[:, 3::4, :] = -1.0   # affine rows: never a valid hit
        self._tri_rows = torch.zeros((self.cap * KC, 16), device=dev)
        self._bounds = torch.as_tensor(
            np.asarray(world_bounds, np.float32), device=dev)
        self._free: List[int] = list(range(self.cap - 1, -1, -1))
        self._slots: Dict[ChunkKey, List[int]] = {}
        self.overflowed = 0   # clusters dropped for want of capacity

    @property
    def device(self) -> torch.device:
        return self._cbmin.device

    @property
    def n_used(self) -> int:
        return self.cap - len(self._free)

    def update_chunks(self, items: Iterable[Tuple[ChunkKey, np.ndarray,
                                                  np.ndarray]]) -> None:
        """Batch (key, tris, mats) updates: free old rows, pack, allocate,
        and write each table once."""
        idx: List[int] = []
        bmin: List[np.ndarray] = []
        bmax: List[np.ndarray] = []
        gm: List[np.ndarray] = []
        tr: List[np.ndarray] = []
        freed: List[int] = []
        for key, tris, mats in items:
            freed.extend(self._slots.pop(key, ()))
            if tris.shape[0] == 0:
                continue
            cbmin, cbmax, gmat, tri_rows = pack_cluster_blocks(
                tris[:, 0], tris[:, 1], tris[:, 2], mats)
            got: List[int] = []
            for ci in range(cbmin.shape[0]):
                # Rows freed in this same batch are reusable immediately:
                # their new content overwrites before any trace sees them.
                if freed:
                    s = freed.pop()
                elif self._free:
                    s = self._free.pop()
                else:
                    self.overflowed += cbmin.shape[0] - ci
                    break
                got.append(s)
                idx.append(s)
                bmin.append(cbmin[ci])
                bmax.append(cbmax[ci])
                gm.append(gmat[ci])
                tr.append(tri_rows[ci * KC:(ci + 1) * KC])
            self._slots[key] = got
        for s in freed:   # leftovers: mark degenerate + return to pool
            idx.append(s)
            bmin.append(np.full(3, 1e30, np.float32))
            bmax.append(np.full(3, -1e30, np.float32))
            gm.append(None)
            tr.append(None)
            self._free.append(s)
        if not idx:
            return
        dev = self.device
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        ii = put(np.asarray(idx, np.int64))
        self._cbmin.index_copy_(0, ii, put(np.stack(bmin)))
        self._cbmax.index_copy_(0, ii, put(np.stack(bmax)))
        live = [k for k, g in enumerate(gm) if g is not None]
        if live:
            rows = np.asarray([idx[k] for k in live], np.int64)
            self._gmat.index_copy_(0, put(rows),
                                   put(np.stack([gm[k] for k in live])))
            flat = (rows[:, None] * KC
                    + np.arange(KC, dtype=np.int64)[None, :]).reshape(-1)
            self._tri_rows.index_copy_(
                0, put(flat), put(np.concatenate([tr[k] for k in live])))

    def remove_chunks(self, keys: Iterable[ChunkKey]) -> None:
        self.update_chunks((k, np.zeros((0, 3, 3), np.float32),
                            np.zeros(0, np.int32)) for k in keys)

    def clusters(self) -> MeshClusters:
        return MeshClusters(cbmin=self._cbmin, cbmax=self._cbmax,
                            gmat=self._gmat, tri_rows=self._tri_rows,
                            bounds=self._bounds, t_bias=self.t_bias)
