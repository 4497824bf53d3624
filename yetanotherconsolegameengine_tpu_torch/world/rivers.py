"""River network: D8 flow directions + accumulation + carve depth
(RiverNetworkGlobal.cs:7-86 / RiverNetwork.cs).

The reference computes, over a heightfield: steepest-descent D8 flow
directions, flow accumulation in ascending height order, then a carve
depth and river water surface per column. This is inherently a global
sweep; it is vectorized here except the height-ordered accumulation pass,
which is a single O(n) scatter loop over sorted columns.
"""

from __future__ import annotations

import numpy as np

from .settings import WorldGenSettings

# D8 neighbor offsets (dx, dz).
_D8 = np.asarray([(-1, -1), (0, -1), (1, -1), (-1, 0),
                  (1, 0), (-1, 1), (0, 1), (1, 1)], np.int64)


def flow_directions(height: np.ndarray) -> np.ndarray:
    """(W, H) height -> (W, H) index into _D8 of the steepest descent, or
    -1 for pits/flats (RiverNetworkGlobal D8 pass)."""
    h = np.asarray(height, np.float64)
    W, H = h.shape
    best_drop = np.zeros((W, H))
    best_dir = np.full((W, H), -1, np.int64)
    dist = np.asarray([np.hypot(dx, dz) for dx, dz in _D8])
    for k, (dx, dz) in enumerate(_D8):
        nh = np.full((W, H), np.inf)
        # nh[x, z] = h[x+dx, z+dz] over the in-bounds region.
        dst_x = slice(max(0, -dx), W - max(0, dx))
        src_x = slice(max(0, dx), W - max(0, -dx))
        dst_z = slice(max(0, -dz), H - max(0, dz))
        src_z = slice(max(0, dz), H - max(0, -dz))
        nh[dst_x, dst_z] = h[src_x, src_z]
        drop = (h - nh) / dist[k]
        better = drop > best_drop
        best_drop[better] = drop[better]
        best_dir[better] = k
    return best_dir


def flow_accumulation(height: np.ndarray, fdir: np.ndarray) -> np.ndarray:
    """Upslope-area accumulation, visiting columns from high to low
    (RiverNetworkGlobal accumulation pass: ascending height order means
    every column pushes its accumulated flow to its downstream neighbor)."""
    h = np.asarray(height, np.float64)
    W, H = h.shape
    acc = np.ones((W, H))
    order = np.argsort(h, axis=None)[::-1]  # highest first
    xs, zs = np.unravel_index(order, (W, H))
    fd = fdir[xs, zs]
    ok = fd >= 0
    dx = _D8[fd[ok], 0]
    dz = _D8[fd[ok], 1]
    tx = xs[ok] + dx
    tz = zs[ok] + dz
    inb = (tx >= 0) & (tx < W) & (tz >= 0) & (tz < H)
    src = np.flatnonzero(ok)[inb]
    # Sequential scatter: each column adds its (already final) accumulation
    # downstream. Order guarantees upstream-before-downstream.
    sx, sz = xs[src], zs[src]
    txx, tzz = tx[inb], tz[inb]
    for i in range(len(src)):
        acc[txx[i], tzz[i]] += acc[sx[i], sz[i]]
    return acc


def compute_for_chunk(height_halo: np.ndarray, pad: int,
                      gs: WorldGenSettings, sea_level: float):
    """Chunk-local rivers (RiverNetwork.ComputeForChunk, RiverNetwork.cs:
    14-116): D8 directions from GLOBAL heights (the halo provides the
    out-of-chunk neighbors), but accumulation restricted to the chunk's
    own cells — flow leaving the chunk is dropped, so live-streamed
    (unsaved) worlds get approximate local rivers with the reference's
    chunk-border discontinuities.

    Deliberate deviation: the reference pushes accumulation in ASCENDING
    height order (RiverNetwork.cs:64-78), which means upstream flow
    arrives AFTER a cell has already pushed — accumulation caps at ~9 and
    with RiverAccumThreshold=50 its chunk rivers never actually carve. We
    push upstream-before-downstream (descending, like both its and our
    GLOBAL passes), so chunk-local rivers genuinely appear.

    height_halo: (C+2*pad, C+2*pad) float heights; returns
    (carve_depth (C, C) float, river_water_y (C, C) float).
    """
    h = np.asarray(height_halo, np.float64)
    fdir = flow_directions(h)
    inner = slice(pad, h.shape[0] - pad), slice(pad, h.shape[1] - pad)
    hi = h[inner]
    C0, C1 = hi.shape

    acc = np.ones((C0, C1))
    order = np.argsort(hi, axis=None)[::-1]     # highest first
    xs, zs = np.unravel_index(order, (C0, C1))
    fd = fdir[inner][xs, zs]
    for i in range(len(xs)):
        k = fd[i]
        if k < 0:
            continue
        tx = xs[i] + _D8[k, 0]
        tz = zs[i] + _D8[k, 1]
        if 0 <= tx < C0 and 0 <= tz < C1:
            acc[tx, tz] += acc[xs[i], zs[i]]
    thresh = gs.river_min_accum
    t = (acc - thresh) / max(thresh, 1e-6)
    depth = np.where(t > 0.0,
                     np.minimum(gs.river_carve_depth,
                                np.maximum(0.0, t) * gs.river_carve_depth),
                     0.0)
    bed = hi - np.floor(depth)
    # Water sits at the carved surface + 1 — the same convention the
    # global carve path uses (worldgen.py: wy = max(wy, hy + 1)), so
    # live-streamed chunks and globally generated worlds agree on the
    # river water level.
    water_y = np.where(depth > 0.0, np.maximum(sea_level, bed + 1.0),
                       sea_level)
    return depth, water_y


def carve(height: np.ndarray, gs: WorldGenSettings):
    """Returns (carved_height, river_mask, water_surface_delta).

    Carve depth grows with log-accumulation past the river threshold
    (RiverNetworkGlobal carve pass)."""
    fdir = flow_directions(height)
    acc = flow_accumulation(height, fdir)
    river = acc >= gs.river_min_accum
    depth = np.where(
        river,
        np.minimum(gs.river_carve_depth,
                   1.0 + np.log1p(acc / gs.river_min_accum)),
        0.0)
    carved = np.asarray(height, np.float64) - depth
    return carved, river, depth
