"""The proxy sets of a cluster mesh, frozen here.

A mesh of at least ``CLUSTER_MIN_TRIS`` triangles is traced from cluster
tables, and rays of most populations never meet it whole: the program's
published rules (the scene table's mesh build, ``scene/tables.py`` of the
port and of the JAX package, and its vertex-clustering simplifier,
``scene/lod.py``) build three coarser proxy sets beside it:

- **fine**, traced by primary rays: the mesh clustered down to
  ``PRIMARY_LOD_TARGET_TRIS``, built only for a mesh of at least three
  times that;
- **lod**, traced by every later round: clustered down to
  ``min(LOD_TARGET_TRIS, max(8192, n // 4))``, kept only when that is at
  most a quarter of the mesh;
- **shadow**, traced by shadow rays: the LOD set clustered down to
  ``SHADOW_LOD_TARGET_TRIS``, kept only beside an LOD set of at least
  twice that.

Each proxy deviates from the surface by up to its grid cell's diagonal, so
rays that start on the surface start the proxy at its ``t_bias``: the LOD
set's own plus the fine set's (secondary origins lie on the fine surface),
the shadow set's plus both. The full set and the fine set start at 0.
Every proxy set packs 512 triangles a cluster, the full set 256; the
nearest-hit key of ``trace.py`` reads that width.

The simplifier is Rossignac–Borrel vertex clustering on a uniform grid:
every vertex snaps to the mean of its cell, triangles whose three cells
are not distinct drop out, and the grid resolution is binary-searched for
the finest grid under the budget.
"""

from __future__ import annotations

import numpy as np

CLUSTER_MIN_TRIS = 16384
LOD_TARGET_TRIS = 24576
SHADOW_LOD_TARGET_TRIS = 6144
PRIMARY_LOD_TARGET_TRIS = 98304
KC = 256          # triangles a cluster of the full set
PROXY_KC = 512    # ... of a proxy set
SETS = ("mesh", "mesh_fine", "mesh_lod", "mesh_shadow")


def simplify(tris: np.ndarray, mats: np.ndarray, target: int):
    """Vertex-cluster ``tris`` (T, 3, 3) to at most ``target`` triangles:
    (tris (T', 3, 3) float32, mats (T',) int32, the cell's diagonal); the
    input itself, and 0, when it is already within the budget."""
    tris = np.asarray(tris, np.float32)
    mats = np.asarray(mats, np.int32)
    if tris.shape[0] <= target:
        return tris, mats, 0.0
    v = tris.reshape(-1, 3)
    lo = v.min(axis=0)
    extent = float(np.max(v.max(axis=0) - lo))
    if extent <= 0.0:
        return tris, mats, 0.0

    def attempt(n_cells: int):
        cell = extent / n_cells
        q = np.clip(((v - lo) / cell).astype(np.int64), 0, n_cells * 2)
        uniq, inv = np.unique((q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2],
                              return_inverse=True)
        inv = inv.reshape(-1)
        count = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
        reps = np.stack([np.bincount(inv, weights=v[:, ax],
                                     minlength=len(uniq))
                         for ax in range(3)], axis=1) / count[:, None]
        cells = inv.reshape(-1, 3)
        keep = ((cells[:, 0] != cells[:, 1]) & (cells[:, 1] != cells[:, 2])
                & (cells[:, 0] != cells[:, 2]))
        return reps[cells[keep]].astype(np.float32), mats[keep], cell

    lo_n, hi_n = 4, 512
    best = attempt(lo_n)
    while lo_n + 1 < hi_n:
        mid = (lo_n + hi_n) // 2
        cand = attempt(mid)
        if cand[0].shape[0] <= target:
            best, lo_n = cand, mid
        else:
            hi_n = mid
    out, m, cell = best
    return out, m, float(cell * np.sqrt(3.0))


def proxy_sets(tris: np.ndarray, mats: np.ndarray, budgets=None) -> dict:
    """{set name: (tris, mats, t_bias)} of the proxy sets of a cluster
    mesh. ``budgets`` None: by the published rules above. Else a dict of
    ``fine``, ``lod`` and ``shadow`` budgets, each set then built without
    the rules' size gates (the shadow set from the LOD set), as the
    program's small test scenes force them."""
    n = tris.shape[0]
    out = {}
    if budgets is None:
        lod_target = min(LOD_TARGET_TRIS, max(8192, n // 4))
        fine_target = (PRIMARY_LOD_TARGET_TRIS
                       if n >= 3 * PRIMARY_LOD_TARGET_TRIS else None)
    else:
        lod_target, fine_target = budgets["lod"], budgets["fine"]
    lod_tris, lod_mats, lod_bias = simplify(tris, mats, lod_target)
    fine_bias = 0.0
    if fine_target is not None:
        f_tris, f_mats, fine_bias = simplify(tris, mats, fine_target)
        out["mesh_fine"] = (f_tris, f_mats, 0.0)
    if budgets is not None or lod_tris.shape[0] <= n // 4:
        out["mesh_lod"] = (lod_tris, lod_mats, lod_bias + fine_bias)
        if budgets is not None \
                or lod_tris.shape[0] >= 2 * SHADOW_LOD_TARGET_TRIS:
            s_tris, s_mats, s_bias = simplify(
                lod_tris, lod_mats, SHADOW_LOD_TARGET_TRIS
                if budgets is None else budgets["shadow"])
            out["mesh_shadow"] = (s_tris, s_mats,
                                  lod_bias + fine_bias + s_bias)
    return out
