"""Cluster-mesh traversal: host build, ray binning, tile cull, resolve.

Port of ``yetanotherconsolegameengine_tpu/ops/mesh_clusters.py``:

  1. HOST BUILD (numpy): triangles sorted into a spatially coherent order
     by recursive median splits and packed into consecutive clusters of
     exactly ``kc`` (256; proxy sets 512) with tight AABBs. Each cluster
     carries its triangles' Woop world->barycentric rows as one (12, kc)
     block: rows U x/y/z/affine, V x/y/z/affine, W x/y/z/affine. The JAX
     package keeps each field group in 8 rows (4 zero rows of TPU sublane
     padding, (C, 24, kc)); ``gmat_from_jax`` drops them.
  2. CULL (on the card the prep and cull kernels of csrc/cluster_glue.cu
     around a torch.sort; torch in the twin): rays that cannot touch the
     mesh's bounds within their [tmin, tmax] drop out, the rest are
     optionally binned (stable sort by direction octant and
     origin/direction Morton codes), cut into tiles of 256 rays and 64-ray
     sub-bundles, and every sub-bundle frustum is tested against every
     cluster AABB by interval arithmetic. The result is, per tile, a
     near-to-far list of candidate clusters.
  3. KERNEL K3 (ops/cluster_kernel.py): per tile, the nearest hit over the
     list's triangles with an exact early exit.
  4. RESOLVE (on the card the resolve kernel; torch in the twin): one row
     gather per ray fetches the winning triangle and re-runs
     Möller–Trumbore for t/u/v, as the JAX package does.

The torch steps 2 and 4 (``_sweep``) are the plain twin, for CPU tensors
and ``impl="plain"``; the kernels (``_sweep_kernels``) equal it bit for
bit, so K3 sees the same lists.

Every lane count inside ``intersect_clusters`` is static and nothing in it
waits on the host: list lengths stay on the device, where the kernel reads
them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..devices import resolve_impl
from ..scene._tensors import Tensors
from ..utils import profiling
from . import cluster_kernel, kernels
from .intersect import INF, Hit, _bound, _safe_div, cross3, dot3

KC = 256        # triangles per cluster of a full mesh (proxy sets: 512)
TILE = cluster_kernel.TILE
SUB_W = 64      # rays per cull sub-bundle (frustum granularity)
# The cull kernel orders a tile's list in shared memory for up to this many
# clusters (kSortMax in csrc/cluster_glue.cu); a larger set leaves the
# order to torch.sort, which costs a sweep more launches (PERF.md § 6).
SORT_MAX = 4096
# The JAX kernel orders candidates by t with its low log2(VISIT_BATCH * kc)
# mantissa bits replaced by the candidate's index, so hits within ~1e-4
# relative t tie there. The winner key clears the same bits of t (ties then
# go to the earlier list entry, then the lower slot, as there): with exact
# t the cluster_forced golden misses 2e-3 at one cell, where a shared edge
# resolves to its other triangle.
_JAX_VISIT_BATCH = 4
_WOOP_ROWS = (0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19)


def tie_mask(kc: int) -> int:
    """Low bits of t cleared in the winner key."""
    return _JAX_VISIT_BATCH * kc - 1


@dataclasses.dataclass(frozen=True)
class MeshClusters(Tensors):
    """Cluster tables of one mesh (static per mesh)."""

    cbmin: torch.Tensor     # (C, 3) cluster AABB min
    cbmax: torch.Tensor     # (C, 3)
    gmat: torch.Tensor      # (C, 12, kc) Woop rows U/V/W x/y/z/affine
    tri_rows: torch.Tensor  # (C*kc, 16): a(3) e1(3) e2(3) n(3) mat 0 0 0
    bounds: torch.Tensor    # (2, 3) mesh AABB
    # Self-intersection guard of a proxy set (scene/lod.py): secondary
    # rays that start on the full mesh clamp tmin to it.
    t_bias: float = 0.0

    @property
    def n_clusters(self) -> int:
        return self.cbmin.shape[0]

    @property
    def kc(self) -> int:
        return self.gmat.shape[2]


def gmat_from_jax(gmat24: np.ndarray) -> np.ndarray:
    """The JAX package's (C, 24, kc) blocks -> the port's (C, 12, kc)."""
    return np.ascontiguousarray(np.asarray(gmat24)[:, _WOOP_ROWS, :])


def _woop_rows(a: np.ndarray, b: np.ndarray, c: np.ndarray):
    """Per-triangle world->barycentric affine rows (float64 inverse).

    Returns (rows (T, 3, 3) = U/V/W vectors, const (T, 3) = -U.A, -V.A,
    -W.A). Degenerate triangles get zero rows and const -1: never valid.
    """
    a64 = a.astype(np.float64)
    e1 = b.astype(np.float64) - a64
    e2 = c.astype(np.float64) - a64
    n = np.cross(e1, e2)
    s = np.stack([e1, e2, n], axis=-1)          # (T, 3, 3) columns e1|e2|n
    det = np.linalg.det(s)
    ok = np.abs(det) > 1e-18
    s_safe = np.where(ok[:, None, None], s, np.eye(3)[None])
    inv = np.linalg.inv(s_safe)                  # (T, 3, 3) rows U/V/W
    inv = np.where(ok[:, None, None], inv, 0.0)
    const = -np.einsum("tij,tj->ti", inv, a64)
    const = np.where(ok[:, None], const, -1.0)
    return inv.astype(np.float32), const.astype(np.float32)


def pack_cluster_blocks(a: np.ndarray, b: np.ndarray, c: np.ndarray,
                        mat: np.ndarray, kc: int = KC):
    """Host packing of triangles into ``kc``-wide cluster blocks.

    Returns numpy ``(cbmin (C, 3), cbmax (C, 3), gmat (C, 12, kc),
    tri_rows (C*kc, 16))``, equal to the JAX package's arrays (its gmat
    through ``gmat_from_jax``). Padding slots of the last cluster have zero
    rows and affine -1 (never valid) and zero tri_rows."""
    assert kc & (kc - 1) == 0, "kc must be a power of two"
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    c = np.asarray(c, np.float32)
    mat = np.asarray(mat, np.int32)
    T = a.shape[0]
    tmin = np.minimum(np.minimum(a, b), c)
    tmax = np.maximum(np.maximum(a, b), c)
    cent = (tmin + tmax) * 0.5

    # Recursive median sort down to kc/4-sized leaves: a spatially coherent
    # linear order, so consecutive runs of kc make tight clusters.
    order = np.arange(T)
    stack = [(0, T)]
    while stack:
        lo, hi = stack.pop()
        if hi - lo <= max(kc // 4, 32):
            continue
        idx = order[lo:hi]
        cb = cent[idx]
        ax = int(np.argmax(cb.max(axis=0) - cb.min(axis=0)))
        srt = np.argsort(cb[:, ax], kind="stable")
        order[lo:hi] = idx[srt]
        mid = lo + (hi - lo) // 2
        stack.append((mid, hi))
        stack.append((lo, mid))

    C = (T + kc - 1) // kc
    pad = C * kc - T
    a_s, b_s, c_s, m_s = a[order], b[order], c[order], mat[order]
    rows, const = _woop_rows(a_s, b_s, c_s)

    def slots(x, fill):
        """(T, ...) sorted per-triangle values -> (C, kc, ...) slots."""
        x = np.concatenate([x, np.full((pad,) + x.shape[1:], fill, x.dtype)])
        return x.reshape((C, kc) + x.shape[1:])

    cbmin = slots(tmin[order], np.inf).min(axis=1).astype(np.float32)
    cbmax = slots(tmax[order], -np.inf).max(axis=1).astype(np.float32)
    # gmat[c, 4*f + comp, k] = rows[., f, comp]; gmat[c, 4*f + 3, k] = const.
    wo = np.concatenate([rows, const[:, :, None]], axis=2)   # (T, 3, 4)
    gmat = np.ascontiguousarray(
        slots(wo.reshape(T, 12), 0.0).transpose(0, 2, 1))     # (C, 12, kc)
    if pad:
        gmat[-1, 3::4, kc - pad:] = -1.0

    e1 = b_s - a_s
    e2 = c_s - a_s
    nrm = np.cross(e1, e2)
    ln = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = nrm / np.maximum(ln, 1e-20)
    tri_rows = np.zeros((C * kc, 16), np.float32)
    tri_rows[:T, 0:3] = a_s
    tri_rows[:T, 3:6] = e1
    tri_rows[:T, 6:9] = e2
    tri_rows[:T, 9:12] = nrm
    tri_rows[:T, 12] = m_s
    return cbmin, cbmax, gmat, tri_rows


def build_clusters(a: np.ndarray, b: np.ndarray, c: np.ndarray,
                   mat: np.ndarray, t_bias: float = 0.0,
                   kc: int = KC) -> MeshClusters:
    """Spatial-sort + consecutive-kc packing host build (CPU tensors)."""
    cbmin, cbmax, gmat, tri_rows = pack_cluster_blocks(a, b, c, mat, kc=kc)
    bounds = np.stack([cbmin.min(axis=0), cbmax.max(axis=0)])
    t = torch.from_numpy
    return MeshClusters(cbmin=t(cbmin), cbmax=t(cbmax), gmat=t(gmat),
                        tri_rows=t(tri_rows), bounds=t(bounds),
                        t_bias=float(t_bias))


# ---------------------------------------------------------------------------
# Cull: sub-bundle frusta against cluster AABBs (conservative intervals)
# ---------------------------------------------------------------------------

def _axis_interval(ol, oh, dl, dh, lo, hi):
    """Conservative [t_lo, t_hi] during which any ray with origin in
    [ol, oh] and direction in [dl, dh] can be inside slab [lo, hi]; an
    unbounded case gives [0, INF)."""
    overlap = (oh >= lo) & (ol <= hi)
    right = ol > hi     # every origin right of the slab
    t_lo = torch.where(
        overlap, 0.0,
        torch.where(right,
                    torch.where(dl < 0.0, (hi - ol) / dl, INF),
                    torch.where(dh > 0.0, (lo - oh) / dh, INF)))
    t_hi = torch.where(dl > 0.0, (hi - ol) / dl,
                       torch.where(dh < 0.0, (lo - oh) / dh, INF))
    return t_lo, torch.clamp(t_hi, min=0.0)


def _tile_cull(o_t, d_t, act_t, tmax_t, cbmin, cbmax):
    """Per-tile near-to-far candidate lists from SUB_W-ray sub-bundles.

    o_t/d_t: (n_tiles, T, 3). Returns (ids (n_tiles, C) i32, entry_t
    (n_tiles, C) f32 ascending, lens (n_tiles,) i32): candidates first,
    ties in cluster order."""
    big = 2.0e30
    n_tiles, tile = o_t.shape[0], o_t.shape[1]
    C = cbmin.shape[0]
    S = max(1, tile // SUB_W)
    o_s = o_t.reshape(n_tiles, S, tile // S, 3)
    d_s = d_t.reshape(n_tiles, S, tile // S, 3)
    a_s = act_t.reshape(n_tiles, S, tile // S)
    x_s = tmax_t.reshape(n_tiles, S, tile // S)
    a3 = a_s[..., None]
    ol = torch.where(a3, o_s, big).amin(2)           # (n_tiles, S, 3)
    oh = torch.where(a3, o_s, -big).amax(2)
    dl = torch.where(a3, d_s, big).amin(2)
    dh = torch.where(a3, d_s, -big).amax(2)
    any_act = a_s.any(2)                             # (n_tiles, S)
    tmax_hi = torch.where(a_s, x_s, 0.0).amax(2)

    t_lo = torch.zeros((n_tiles, S, C), device=o_t.device)
    t_hi = torch.full_like(t_lo, INF)
    for ax in range(3):
        lo_a, hi_a = _axis_interval(
            ol[:, :, ax:ax + 1], oh[:, :, ax:ax + 1],
            dl[:, :, ax:ax + 1], dh[:, :, ax:ax + 1],
            cbmin[None, None, :, ax], cbmax[None, None, :, ax])
        t_lo = torch.maximum(t_lo, lo_a)
        t_hi = torch.minimum(t_hi, hi_a)

    cand_s = ((t_lo <= t_hi * 1.0001 + 1e-4)
              & (t_lo < tmax_hi[..., None]) & any_act[..., None])
    key = torch.where(cand_s, t_lo, INF).amin(1)    # (n_tiles, C)
    entry_t, ids = torch.sort(key, dim=1, stable=True)
    lens = cand_s.any(1).sum(1, dtype=torch.int32)
    return ids.to(torch.int32), entry_t, lens


# ---------------------------------------------------------------------------
# Ray binning + end-to-end intersect
# ---------------------------------------------------------------------------

def _morton3(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Interleave 3 x ``bits``-bit ints (q: (..., 3) i32) -> Morton code."""
    code = torch.zeros(q.shape[:-1], dtype=torch.int32, device=q.device)
    for b in range(bits):
        for ax in range(3):
            code = code | (((q[..., ax] >> b) & 1) << (3 * b + ax))
    return code


def _sort_keys(o, d, active, bounds):
    """Direction octant, then origin Morton, then direction Morton. A
    stable sort keeps the caller's order within equal keys."""
    oct_ = ((d[:, 0] < 0).to(torch.int32)
            | ((d[:, 1] < 0).to(torch.int32) << 1)
            | ((d[:, 2] < 0).to(torch.int32) << 2))
    span = torch.clamp(bounds[1] - bounds[0], min=1e-6)
    q = torch.clamp((o - bounds[0]) / span * 31.0, 0.0, 31.0).to(torch.int32)
    dq = torch.clamp(d.abs() * 3.999, 0.0, 3.0).to(torch.int32)
    key = (oct_ << 21) | (_morton3(q, 5) << 6) | _morton3(dq, 2)
    return torch.where(active, key, 1 << 29)


def _column(x, P, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = torch.as_tensor(x, dtype=torch.float32, device=device)
    else:   # a blocking copy from the host on a card
        t = profiling.sync("mesh_clusters.bound_upload", torch.as_tensor, x,
                           dtype=torch.float32, device=device)
    return t.expand(P).contiguous()


def intersect_clusters(mc: MeshClusters, o, d, tmin, tmax,
                       any_hit: bool = False, presort: bool = True,
                       impl=None, stats: bool = False):
    """Hit query over the cluster tables. o/d: (P, 3); tmin/tmax scalar or
    (P,). Double-sided; the normal is flipped against the ray.

    ``any_hit=True`` (only where every mesh material is opaque) returns a
    blocking hit per ray instead of the nearest, and skips the resolve.
    ``presort=False`` tiles the caller's lane order. ``impl`` "kernel"
    sweeps with the cull and resolve kernels around K3
    (``_sweep_kernels``), "plain" with the torch cull and resolve around
    K3's plain version (``_sweep``); None picks from the rays' device and
    "kernel" off CUDA raises. ``stats=True`` also returns (entries tested,
    list length) per tile.

    Counts ``clusters.sweeps`` (one a call), ``clusters.rays`` (P) and
    ``clusters.kernel_sweeps`` or ``clusters.plain_sweeps`` by the path,
    and opens the span ``clusters.sweep`` around the whole, with
    ``clusters.cull`` (prefilter, binning sort, tile cull) and
    ``clusters.resolve`` (unsort, row gather, recompute) inside it."""
    impl = resolve_impl(impl, o.device)
    profiling.count("clusters.sweeps")
    profiling.count("clusters.rays", o.shape[0])
    profiling.count(f"clusters.{impl}_sweeps")
    sweep = _sweep_kernels if impl == "kernel" else _sweep
    with profiling.span("clusters.sweep"):
        res, steps, lens = sweep(mc, o, d, tmin, tmax, any_hit,
                                 bool(presort))
    if stats:
        return res, (steps, lens)
    return res


def _sweep(mc: MeshClusters, o, d, tmin, tmax, any_hit: bool,
           presort: bool):
    """The plain twin of ``intersect_clusters`` under its span: (hit,
    steps, lens)."""
    P = o.shape[0]
    dev = o.device
    T = TILE
    with profiling.span("clusters.cull"):
        t_lo = _column(tmin, P, dev)
        t_hi = _column(tmax, P, dev)
        Pp = (P + T - 1) // T * T
        pad = Pp - P
        bounds = mc.bounds
        active = o.abs().amax(1) < 1.0e30
        # Global-AABB prefilter and per-ray window clamp.
        inv_d = _safe_div(torch.ones_like(d), d)
        ta = (bounds[0][None] - o) * inv_d
        tb = (bounds[1][None] - o) * inv_d
        tn = torch.minimum(ta, tb).amax(1)
        tf = torch.maximum(ta, tb).amin(1)
        active = active & (tn <= tf) & (tf >= t_lo) & (tn <= t_hi)
        t_hi = torch.minimum(t_hi, tf * 1.0001 + 1e-3)
        o_p, d_p = o, d
        if pad:
            o_p = torch.cat([o, torch.zeros((pad, 3), device=dev)])
            d_p = torch.cat([d, torch.ones((pad, 3), device=dev)])
            z = torch.zeros(pad, device=dev)
            t_lo = torch.cat([t_lo, z])
            t_hi = torch.cat([t_hi, z])
            active = torch.cat([active, z.bool()])

        if presort:
            key = _sort_keys(o_p, d_p, active, bounds)
            sidx = torch.sort(key, stable=True).indices
            # One packed row gather; active rides in the sign of t_hi (an
            # active window is strictly positive).
            thi_m = torch.where(active, t_hi, -1.0)
            rows8 = torch.cat([o_p, d_p, t_lo[:, None], thi_m[:, None]],
                              1)[sidx]
            o_s, d_s, tlo_s = rows8[:, 0:3], rows8[:, 3:6], rows8[:, 6]
            act_s = rows8[:, 7] >= 0.0
            thi_s = torch.clamp(rows8[:, 7], min=0.0)
        else:
            o_s, d_s, tlo_s, thi_s, act_s = o_p, d_p, t_lo, t_hi, active

        n_tiles = Pp // T
        ids, entry_t, lens = _tile_cull(
            o_s.reshape(n_tiles, T, 3), d_s.reshape(n_tiles, T, 3),
            act_s.reshape(n_tiles, T), thi_s.reshape(n_tiles, T),
            mc.cbmin, mc.cbmax)
    tinit = torch.where(act_s, torch.clamp(thi_s, max=3.0e37), -float("inf"))
    rays = torch.cat([o_s, d_s, tlo_s[:, None], tinit[:, None]], 1)
    t_w, win, steps = cluster_kernel.trace_tiles_plain(
        lens, ids, entry_t, mc.gmat, rays, any_hit, tie_mask(mc.kc))

    with profiling.span("clusters.resolve"):
        # Unsort the two winner words with one permutation scatter.
        words = torch.stack([t_w.view(torch.int32), win], 1)
        if presort:
            words = torch.empty_like(words).index_copy_(0, sidx, words)
        t_w = words[:P, 0].view(torch.float32)
        win = words[:P, 1]
        hit = win >= 0

        if any_hit:
            z = torch.zeros_like(t_w)
            mat0 = mc.tri_rows[0, 12].to(torch.int32)
            res = Hit(t=torch.where(hit, t_w, INF), n=-d, u=z, v=z,
                      mat=torch.where(hit, mat0, 0), hit=hit)
        else:
            flat = torch.where(hit, win, 0).long()
            row = mc.tri_rows[flat]                     # the per-ray gather
            a, e1, e2, n = row[:, 0:3], row[:, 3:6], row[:, 6:9], row[:, 9:12]
            # Exact single-triangle Möller–Trumbore recompute.
            h = cross3(d, e2)
            det = dot3(e1, h)
            inv_det = _safe_div(torch.ones_like(det), det)
            s = o - a
            u = dot3(s, h) * inv_det
            q = cross3(s, e1)
            v = dot3(d, q) * inv_det
            t = dot3(e2, q) * inv_det
            ok = det.abs() >= 1e-12
            t = torch.where(ok, t, t_w)
            u = torch.clamp(torch.where(ok, u, 0.0), 0.0, 1.0)
            v = torch.clamp(torch.where(ok, v, 0.0), 0.0, 1.0)
            n = torch.where((dot3(n, d) < 0.0)[:, None], n, -n)
            res = Hit(t=torch.where(hit, t, INF), n=n, u=u, v=v,
                      mat=row[:, 12].to(torch.int32), hit=hit)
    return res, steps, lens


# ---------------------------------------------------------------------------
# The card's path: csrc/cluster_glue.cu around the binning sort and K3
# ---------------------------------------------------------------------------

def _sweep_kernels(mc: MeshClusters, o, d, tmin, tmax, any_hit: bool,
                   presort: bool):
    """``_sweep``'s result, bit for bit, from the prep, cull and resolve
    kernels around ``torch.sort`` and K3 (``cluster_kernel.trace_tiles``):
    o/d (P, 3) f32 and the tables on one CUDA device, tmin/tmax a number
    (a kernel argument) or a tensor of P lanes. Nothing here waits on the
    host; an empty batch launches none of the three."""
    P = o.shape[0]
    o, d = o.contiguous(), d.contiguous()
    kernels.require(o, "o", torch.float32, (P, 3))
    kernels.require(d, "d", torch.float32, (P, 3))
    C = mc.n_clusters
    kernels.require(mc.bounds, "bounds", torch.float32, (2, 3))
    kernels.require(mc.cbmin, "cbmin", torch.float32, (C, 3))
    kernels.require(mc.cbmax, "cbmax", torch.float32, (C, 3))
    kernels.require(mc.tri_rows, "tri_rows", torch.float32, (C * mc.kc, 16))
    dev = o.device
    Pp = (P + TILE - 1) // TILE * TILE
    n_tiles = Pp // TILE
    lib = kernels.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with profiling.span("clusters.cull"):
        lo, lo_s = _bound(tmin, o)
        hi, hi_s = _bound(tmax, o)
        rows = torch.empty((Pp, 8), device=dev)
        key = torch.empty(Pp, dtype=torch.int32, device=dev)
        if P:
            kernels.check(lib.yacge_cluster_prep_launch(
                o.data_ptr(), d.data_ptr(), _ptr(lo), lo_s, _ptr(hi), hi_s,
                mc.bounds.data_ptr(), P, Pp, int(presort), rows.data_ptr(),
                key.data_ptr(), stream), "cluster prep kernel")
            kernels.LAUNCHES["cluster_prep"] += 1
        sidx = torch.sort(key, stable=True).indices if presort else None
        rays = torch.empty((Pp, 8), device=dev)
        ids = torch.empty((n_tiles, C), dtype=torch.int32, device=dev)
        entry_t = torch.empty((n_tiles, C), device=dev)
        lens = torch.empty(n_tiles, dtype=torch.int32, device=dev)
        pairs = 1 << (C - 1).bit_length() if 0 < C <= SORT_MAX else 0
        if P:
            kernels.check(lib.yacge_cluster_cull_launch(
                rows.data_ptr(), key.data_ptr(), _ptr(sidx),
                mc.cbmin.data_ptr(), mc.cbmax.data_ptr(), n_tiles, C, pairs,
                rays.data_ptr(), ids.data_ptr(), entry_t.data_ptr(),
                lens.data_ptr(), stream), "cluster cull kernel")
            kernels.LAUNCHES["cluster_cull"] += 1
        if not pairs:
            entry_t, order = torch.sort(entry_t, dim=1, stable=True)
            ids = order.to(torch.int32)
    t_w, win, steps = cluster_kernel.trace_tiles(
        lens, ids, entry_t, mc.gmat, rays, any_hit, tie_mask(mc.kc))

    with profiling.span("clusters.resolve"):
        t = torch.empty(P, device=dev)
        n = torch.empty((P, 3), device=dev)
        u = torch.empty(P, device=dev)
        v = torch.empty(P, device=dev)
        mat = torch.empty(P, dtype=torch.int32, device=dev)
        hit = torch.empty(P, dtype=torch.bool, device=dev)
        if P:
            kernels.check(lib.yacge_cluster_resolve_launch(
                t_w.data_ptr(), win.data_ptr(), _ptr(sidx), o.data_ptr(),
                d.data_ptr(), mc.tri_rows.data_ptr(), P, Pp, int(any_hit),
                t.data_ptr(), n.data_ptr(), u.data_ptr(), v.data_ptr(),
                mat.data_ptr(), hit.data_ptr(), stream),
                "cluster resolve kernel")
            kernels.LAUNCHES["cluster_resolve"] += 1
    return Hit(t=t, n=n, u=u, v=v, mat=mat, hit=hit), steps, lens


def _ptr(x):
    return None if x is None else x.data_ptr()
