"""Batched ray-primitive intersection over SoA scene tables.

Port of ``yetanotherconsolegameengine_tpu/ops/intersect.py`` for the seven
primitive tables. Each type tests all rays against all rows as one (P, N)
broadcast, then takes the first nearest row with ``argmin`` and gathers its
attributes (the JAX package's one-hot matmul select, ``_first_min`` /
``_sel_rows`` / ``_sel_mat``, exists because a TPU gather is slow). The
per-type winners merge in the fixed order spheres, boxes, rects, cylinders,
disks, planes, triangles, a later type winning only when strictly nearer —
the same selection the trace kernel makes ray by ray. Dot products are
summed x + y + z in that order, as in the kernel.

Every function takes rays ``o``, ``d`` (P, 3) and scalar-or-(P,) ``tmin``
/ ``tmax`` and returns a ``Hit`` with the winner's surface coordinates
u, v (boxes and rects: the face coordinates; triangles: the barycentrics;
zero for the other types), which texture lookup reads.
``intersect_scene`` then sweeps the scene's BVH mesh (ops/mesh_bvh.py) and
its cluster mesh (ops/mesh_clusters.py), each clipped to the primitives'
nearest hit, and last its voxel grid (ops/dda.py), clipped to the nearest
hit so far.
"""

from __future__ import annotations

import dataclasses

import torch

from ..devices import resolve_impl
from ..utils import profiling

INF = 3.0e38


@dataclasses.dataclass(frozen=True)
class Hit:
    t: torch.Tensor     # (P,) hit distance; INF when miss
    n: torch.Tensor     # (P, 3) shading normal; 0 when miss
    u: torch.Tensor     # (P,) surface coordinates; 0 when miss
    v: torch.Tensor     # (P,)
    mat: torch.Tensor   # (P,) i32 material id; 0 when miss
    hit: torch.Tensor   # (P,) bool

    @staticmethod
    def miss(o: torch.Tensor) -> "Hit":
        p = o.shape[0]
        z = torch.zeros((p,), device=o.device)
        return Hit(t=torch.full((p,), INF, device=o.device),
                   n=torch.zeros((p, 3), device=o.device), u=z, v=z,
                   mat=torch.zeros((p,), dtype=torch.int32, device=o.device),
                   hit=torch.zeros((p,), dtype=torch.bool, device=o.device))


def merge(a: Hit, b: Hit) -> Hit:
    take_b = b.hit & (b.t < a.t)
    return Hit(t=torch.where(take_b, b.t, a.t),
               n=torch.where(take_b[:, None], b.n, a.n),
               u=torch.where(take_b, b.u, a.u),
               v=torch.where(take_b, b.v, a.v),
               mat=torch.where(take_b, b.mat, a.mat),
               hit=a.hit | b.hit)


def dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _safe_div(num, den, eps=1e-12):
    s = torch.where(den.abs() < eps, torch.where(den < 0, -eps, eps), den)
    return num / s


def _col(v, o):
    """Scalar or (P,) bound -> (P, 1) f32. A Python number is filled on
    the device, the float32 that a copy from the host would give, so a
    sweep neither waits on the host nor breaks a CUDA graph's capture."""
    if isinstance(v, torch.Tensor):
        t = torch.as_tensor(v, dtype=torch.float32, device=o.device)
    else:
        t = torch.full((), float(v), dtype=torch.float32, device=o.device)
    return t.expand(o.shape[0])[:, None]


def _lanes(v, o):
    """Scalar or (P,) bound -> contiguous (P,) f32 on ``o``'s device, as
    ``_col`` gives it; a Python number is filled on the device, with no
    copy from the host (a kernel's sweep never waits on the host)."""
    if isinstance(v, torch.Tensor):
        return v.to(o.device, torch.float32).expand(o.shape[0]).contiguous()
    return torch.full((o.shape[0],), float(v), dtype=torch.float32,
                      device=o.device)


def _first_min(tm, mask):
    """(P, N) candidate t (INF = miss) -> (tbest, row index, hit), taking
    the first row among equal minima."""
    tm = torch.where(mask[None, :], tm, INF)
    idx = torch.argmin(tm, dim=1)
    tbest = tm.gather(1, idx[:, None])[:, 0]
    return tbest, idx, tbest < INF


def _pick(pn, idx):
    """Winner of a per-candidate (P, N) quantity -> (P,)."""
    return pn.gather(1, idx[:, None])[:, 0]


def _flip_against(nrm, d):
    return torch.where((dot3(nrm, d) < 0)[:, None], nrm, -nrm)


def intersect_spheres(tb, o, d, tmin, tmax) -> Hit:
    if tb.mask.shape[0] == 0:
        return Hit.miss(o)
    tmin, tmax = _col(tmin, o), _col(tmax, o)
    oc = o[:, None, :] - tb.center[None]
    half_b = dot3(oc, d[:, None, :])
    c = dot3(oc, oc) - (tb.radius * tb.radius)[None]
    disc = half_b * half_b - c
    s = torch.sqrt(torch.clamp(disc, min=0.0))
    t_near = -half_b - s
    t_far = -half_b + s
    near_ok = (t_near >= tmin) & (t_near <= tmax)
    far_ok = (t_far >= tmin) & (t_far <= tmax)
    t = torch.where(near_ok, t_near, t_far)
    t = torch.where((disc >= 0.0) & (near_ok | far_ok), t, INF)
    tbest, idx, hit = _first_min(t, tb.mask)
    inv_r = 1.0 / torch.clamp(tb.radius, min=1e-20)
    p = o + tbest[:, None] * d
    n = (p - tb.center[idx]) * inv_r[idx][:, None]
    z = torch.zeros_like(tbest)
    return Hit(t=tbest, n=n, u=z, v=z, mat=tb.mat[idx], hit=hit)


def _face_uv(p, ax, lo, hi):
    """u, v of hit points ``p`` (P, 3) on faces of axis ``ax`` (P,) whose
    extents are ``lo``/``hi`` (P, 3): the two free axes in ascending
    order, each scaled to [0, 1] over the face."""
    fa = torch.where(ax == 0, 1, 0)[:, None]
    fb = torch.where(ax == 2, 1, 2)[:, None]
    pick = lambda x, f: x.gather(1, f)[:, 0]
    u = _safe_div(pick(p, fa) - pick(lo, fa), pick(hi, fa) - pick(lo, fa))
    v = _safe_div(pick(p, fb) - pick(lo, fb), pick(hi, fb) - pick(lo, fb))
    return u, v


def intersect_boxes(tb, o, d, tmin, tmax) -> Hit:
    """Slab test: the entry face, or the exit face when the origin is
    inside; the normal is flipped against the ray."""
    if tb.mask.shape[0] == 0:
        return Hit.miss(o)
    tmin, tmax = _col(tmin, o), _col(tmax, o)
    inv_d = _safe_div(torch.ones_like(d), d)
    ta = (tb.bmin[None] - o[:, None, :]) * inv_d[:, None, :]
    tc = (tb.bmax[None] - o[:, None, :]) * inv_d[:, None, :]
    tn = torch.minimum(ta, tc)
    tf = torch.maximum(ta, tc)
    t0 = tn.amax(-1)
    t1 = tf.amin(-1)
    enter_ok = (t0 <= t1) & (t0 >= tmin) & (t0 <= tmax)
    exit_ok = (t0 <= t1) & (t1 >= tmin) & (t1 <= tmax)
    t = torch.where(enter_ok, t0, t1)
    axis = torch.where(enter_ok, tn.argmax(-1), tf.argmin(-1))
    t = torch.where(enter_ok | exit_ok, t, INF)
    tbest, idx, hit = _first_min(t, tb.mask)
    ax = _pick(axis, idx)
    d_axis = d.gather(1, ax[:, None])[:, 0]
    n = torch.nn.functional.one_hot(ax, 3).to(torch.float32) \
        * torch.where(d_axis < 0, 1.0, -1.0)[:, None]
    u, v = _face_uv(o + tbest[:, None] * d, ax, tb.bmin[idx], tb.bmax[idx])
    return Hit(t=tbest, n=n, u=u, v=v, mat=tb.mat[idx], hit=hit)


def intersect_rects(tb, o, d, tmin, tmax) -> Hit:
    if tb.mask.shape[0] == 0:
        return Hit.miss(o)
    tmin, tmax = _col(tmin, o), _col(tmax, o)
    axis = tb.axis.long()
    fa = torch.where(axis == 0, 1, 0)
    fb = torch.where(axis == 2, 1, 2)
    d_ax = d[:, axis]
    ad = d_ax.abs()
    safe = torch.where(ad < 1e-8, torch.where(d_ax < 0, -1e-8, 1e-8), d_ax)
    t = (tb.k[None] - o[:, axis]) / safe
    pu = o[:, fa] + t * d[:, fa]
    pv = o[:, fb] + t * d[:, fb]
    valid = ((ad >= 1e-8) & (t >= tmin) & (t <= tmax)
             & (pu >= tb.u0[None]) & (pu <= tb.u1[None])
             & (pv >= tb.v0[None]) & (pv <= tb.v1[None]))
    tbest, idx, hit = _first_min(torch.where(valid, t, INF), tb.mask)
    ax = axis[idx]
    d_axis = d.gather(1, ax[:, None])[:, 0]
    n = torch.nn.functional.one_hot(ax, 3).to(torch.float32) \
        * torch.where(d_axis < 0, 1.0, -1.0)[:, None]
    u0, u1, v0, v1 = (getattr(tb, f)[idx] for f in ("u0", "u1", "v0", "v1"))
    u = _safe_div(_pick(pu, idx) - u0, u1 - u0)
    v = _safe_div(_pick(pv, idx) - v0, v1 - v0)
    return Hit(t=tbest, n=n, u=u, v=v, mat=tb.mat[idx], hit=hit)


def intersect_cylinders(tb, o, d, tmin, tmax) -> Hit:
    """Capped Y cylinders: the near side root wins if in range, else the
    far root; caps override only when closer."""
    if tb.mask.shape[0] == 0:
        return Hit.miss(o)
    tmin, tmax = _col(tmin, o), _col(tmax, o)
    ox = o[:, 0:1] - tb.cx[None]
    oy = o[:, 1:2]
    oz = o[:, 2:3] - tb.cz[None]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    r2 = (tb.radius * tb.radius)[None]
    a = dx * dx + dz * dz
    half_b = ox * dx + oz * dz
    c = ox * ox + oz * oz - r2
    disc = half_b * half_b - a * c
    s = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_a = _safe_div(torch.ones_like(a), a)
    quad_ok = (a > 1e-12) & (disc >= 0.0)

    def side_valid(t):
        y = oy + t * dy
        return (quad_ok & (t > tmin) & (t < tmax)
                & (y >= tb.ymin[None]) & (y <= tb.ymax[None]))

    t1 = (-half_b - s) * inv_a
    t2 = (-half_b + s) * inv_a
    v1 = side_valid(t1)
    v2 = side_valid(t2) & ~v1
    t_cur = torch.where(v1, t1, torch.where(v2, t2, INF))
    cap_possible = tb.capped[None] & (dy.abs() > 1e-8)

    def cap(ky, t_cur):
        t = _safe_div(ky[None] - oy, dy)
        rx = ox + t * dx
        rz = oz + t * dz
        ok = (cap_possible & (t > tmin) & (t < tmax)
              & (rx * rx + rz * rz <= r2) & (t < t_cur))
        return torch.where(ok, t, t_cur), ok

    t_cur, top_ok = cap(tb.ymax, t_cur)
    t_cur, bot_ok = cap(tb.ymin, t_cur)
    valid = v1 | v2 | top_ok | bot_ok
    tbest, idx, hit = _first_min(torch.where(valid, t_cur, INF), tb.mask)
    is_top = _pick(top_ok & ~bot_ok, idx)
    is_bot = _pick(bot_ok, idx)
    inv_r = (1.0 / torch.clamp(tb.radius, min=1e-20))[idx]
    px = o[:, 0] + tbest * d[:, 0]
    pz = o[:, 2] + tbest * d[:, 2]
    zero = torch.zeros_like(px)
    n_side = torch.stack([(px - tb.cx[idx]) * inv_r, zero,
                          (pz - tb.cz[idx]) * inv_r], -1)
    ny = torch.where(is_top, 1.0, torch.where(is_bot, -1.0, 0.0))
    n_cap = torch.stack([zero, ny, zero], -1)
    n = torch.where((is_top | is_bot)[:, None], n_cap, n_side)
    n = torch.where((dot3(n, d) >= 0.0)[:, None], -n, n)
    return Hit(t=tbest, n=n, u=zero, v=zero, mat=tb.mat[idx], hit=hit)


def intersect_disks(tb, o, d, tmin, tmax) -> Hit:
    """The radius test uses the XZ distance only, as the reference does
    (its disks always face +Y)."""
    if tb.mask.shape[0] == 0:
        return Hit.miss(o)
    tmin, tmax = _col(tmin, o), _col(tmax, o)
    nrm = tb.normal[None]
    denom = dot3(d[:, None, :], nrm)
    nd_c = dot3(tb.normal, tb.center)[None]
    no = dot3(o[:, None, :], nrm)
    adenom = denom.abs()
    safe = torch.where(adenom < 1e-8, torch.where(denom < 0, -1e-8, 1e-8),
                       denom)
    t = (nd_c - no) / safe
    ex = o[:, 0:1] + t * d[:, 0:1] - tb.center[None, :, 0]
    ez = o[:, 2:3] + t * d[:, 2:3] - tb.center[None, :, 2]
    valid = ((adenom >= 1e-6) & (t >= tmin) & (t <= tmax)
             & (ex * ex + ez * ez <= (tb.radius * tb.radius)[None]))
    tbest, idx, hit = _first_min(torch.where(valid, t, INF), tb.mask)
    z = torch.zeros_like(tbest)
    return Hit(t=tbest, n=_flip_against(tb.normal[idx], d), u=z, v=z,
               mat=tb.mat[idx], hit=hit)


def intersect_planes(tb, o, d, tmin, tmax) -> Hit:
    if tb.mask.shape[0] == 0:
        return Hit.miss(o)
    tmin, tmax = _col(tmin, o), _col(tmax, o)
    nrm = tb.normal[None]
    denom = dot3(d[:, None, :], nrm)
    no = dot3(o[:, None, :], nrm)
    t = _safe_div(tb.d[None] - no, denom)
    valid = (denom.abs() >= 1e-6) & (t >= tmin) & (t <= tmax)
    tbest, idx, hit = _first_min(torch.where(valid, t, INF), tb.mask)
    z = torch.zeros_like(tbest)
    return Hit(t=tbest, n=_flip_against(tb.normal[idx], d), u=z, v=z,
               mat=tb.mat[idx], hit=hit)


def intersect_triangles(tb, o, d, tmin, tmax) -> Hit:
    """Double-sided Möller–Trumbore."""
    if tb.mask.shape[0] == 0:
        return Hit.miss(o)
    tmin, tmax = _col(tmin, o), _col(tmax, o)
    dd = d[:, None, :].expand(-1, tb.a.shape[0], -1)
    e1, e2 = tb.e1[None], tb.e2[None]
    h = cross3(dd, e2)
    det = dot3(e1, h)
    inv_det = _safe_div(torch.ones_like(det), det)
    s = o[:, None, :] - tb.a[None]
    u = dot3(s, h) * inv_det
    q = cross3(s, e1.expand_as(s))
    v = dot3(dd, q) * inv_det
    t = dot3(e2, q) * inv_det
    valid = ((det.abs() >= 1e-8) & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0) & (t >= tmin) & (t <= tmax))
    tbest, idx, hit = _first_min(torch.where(valid, t, INF), tb.mask)
    return Hit(t=tbest, n=_flip_against(tb.n[idx], d), u=_pick(u, idx),
               v=_pick(v, idx), mat=tb.mat[idx], hit=hit)


INTERSECTORS = (("spheres", intersect_spheres), ("boxes", intersect_boxes),
                ("rects", intersect_rects), ("cylinders", intersect_cylinders),
                ("disks", intersect_disks), ("planes", intersect_planes),
                ("triangles", intersect_triangles))


def intersect_scene(scene, o, d, tmin, tmax, shadow: bool = False,
                    lod: bool = False, fine: bool = False,
                    presort: bool = True, impl=None) -> Hit:
    """Nearest hit across every primitive table, then the BVH mesh, the
    cluster mesh and the voxel grid.

    The primitives' best t (+1e-3) clips both mesh sweeps' tmax, and the
    best t after them clips the voxel sweep's. The
    cluster set follows the population: ``lod`` and ``shadow`` -> the
    shadow proxy set, ``lod`` -> the LOD proxy set, ``fine`` -> the fine
    proxy set, each only when the scene has it (counted under
    ``clusters.sweeps.<full|fine|lod|shadow>``); the proxy sets start at
    ``max(tmin, t_bias)``. ``shadow`` queries run in any-hit mode when
    every mesh material is opaque or the scene's shadows are binary.
    ``presort`` bins the rays before the sweep; ``impl`` picks the
    mesh, cluster and voxel sweeps ("kernel": the walk kernel, K3 and the
    DDA kernel; "plain": their plain versions; None: from the rays'
    device)."""
    impl = resolve_impl(impl, o.device)
    h = Hit.miss(o)
    for name, fn in INTERSECTORS:
        h = merge(h, fn(getattr(scene, name), o, d, tmin, tmax))
    mc = scene.mesh_clusters
    if scene.mesh is None and mc is None and scene.voxels is None:
        return h
    t_clip = torch.minimum(_col(tmax, o)[:, 0], h.t + 1e-3)
    if scene.mesh is not None:
        from .mesh_bvh import intersect_mesh
        h = merge(h, intersect_mesh(scene.mesh, o, d, tmin, t_clip,
                                    impl=impl))
    if mc is not None:
        from .mesh_clusters import intersect_clusters
        mc_tmin = tmin
        proxy = None
        met = "full"
        if lod and shadow and scene.mesh_clusters_shadow is not None:
            proxy, met = scene.mesh_clusters_shadow, "shadow"
        elif lod and scene.mesh_clusters_lod is not None:
            proxy, met = scene.mesh_clusters_lod, "lod"
        elif fine and scene.mesh_clusters_fine is not None:
            mc, met = scene.mesh_clusters_fine, "fine"
        profiling.count("clusters.sweeps." + met)
        if proxy is not None:
            mc = proxy
            mc_tmin = torch.clamp(_col(tmin, o)[:, 0], min=mc.t_bias)
        h = merge(h, intersect_clusters(
            mc, o, d, mc_tmin, t_clip,
            any_hit=shadow and (scene.mesh_all_opaque
                                or scene.binary_shadows),
            presort=presort, impl=impl))
    if scene.voxels is not None:
        from .dda import intersect_voxels
        t_clip = torch.minimum(t_clip, h.t + 1e-3)
        h = merge(h, intersect_voxels(scene.voxels, o, d, tmin, t_clip,
                                      impl=impl))
    return h
