"""Secondary-ray LOD: vertex-clustering mesh simplification (numpy only).

A copy of ``yetanotherconsolegameengine_tpu/scene/lod.py``. Uniform-grid
vertex clustering (Rossignac–Borrel): every vertex snaps to the mean of
its grid cell, triangles whose three cells are not distinct are dropped,
and the grid resolution is binary-searched for the largest grid under a
triangle budget. The proxy ships a conservative ``t_bias`` (the cell
diagonal): secondary rays start beyond it so that origins on the full
surface never hit the displaced proxy skin. scene/tables.py builds the
fine, LOD and shadow proxy sets of a cluster mesh with it.
"""

from __future__ import annotations

import numpy as np


def simplify_soup(tris: np.ndarray, mats: np.ndarray, target_tris: int):
    """Vertex-cluster ``tris`` (T, 3, 3) down to <= ``target_tris``.

    Returns (tris' (T', 3, 3) f32, mats' (T',) i32, cell_size float).
    Falls back to the input when it is already under budget.
    """
    tris = np.asarray(tris, np.float32)
    mats = np.asarray(mats, np.int32)
    T = tris.shape[0]
    if T <= target_tris:
        return tris, mats, 0.0

    v = tris.reshape(-1, 3)
    lo = v.min(axis=0)
    hi = v.max(axis=0)
    extent = float(np.max(hi - lo))
    if extent <= 0.0:
        return tris, mats, 0.0

    def attempt(n_cells: int):
        cell = extent / n_cells
        q = np.clip(((v - lo) / cell).astype(np.int64), 0, n_cells * 2)
        key = (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]
        uniq, inv = np.unique(key, return_inverse=True)
        # Cell representative = mean of the cell's vertices.
        reps = np.zeros((len(uniq), 3), np.float64)
        cnt = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
        for ax in range(3):
            reps[:, ax] = np.bincount(inv, weights=v[:, ax],
                                      minlength=len(uniq))
        reps /= cnt[:, None]
        tri_cells = inv.reshape(-1, 3)
        keep = ((tri_cells[:, 0] != tri_cells[:, 1])
                & (tri_cells[:, 1] != tri_cells[:, 2])
                & (tri_cells[:, 0] != tri_cells[:, 2]))
        out = reps[tri_cells[keep]].astype(np.float32)
        return out, mats[keep], cell

    # Binary search the grid resolution for the largest grid (finest
    # detail) that stays under the triangle budget.
    lo_n, hi_n = 4, 512
    best = attempt(lo_n)
    while lo_n + 1 < hi_n:
        mid = (lo_n + hi_n) // 2
        cand = attempt(mid)
        if cand[0].shape[0] <= target_tris:
            best, lo_n = cand, mid
        else:
            hi_n = mid
    out, m, cell = best
    # Conservative self-intersection bias: the proxy surface deviates from
    # the true surface by at most ~one cell diagonal.
    return out, m, float(cell * np.sqrt(3.0))
