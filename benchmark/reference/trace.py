"""Path tracing of every pixel, plainly.

Each pixel carries a ray, a throughput, mirror and diffuse depth counters,
a path stack (for the two children of a refraction) and a SplitMix64
state. One round intersects every live ray with every primitive and every
mesh triangle (no acceleration structure: a mesh object, and a spatial
group of its triangles, is skipped only for rays that miss its padded
bounding box), adds sky or emission, pushes a
transparent hit's Fresnel-weighted reflection and refraction, shades a
diffuse hit (ambient, and Oren–Nayar direct light from each light with
inverse-square falloff and coloured transmittance through up to
``max_refractions`` transparent hits) and continues a mirror or a cosine
bounce, else pops the stack. Rounds repeat until no ray is live. The
first hit of the primary ray fills the G-buffer (albedo, normal, depth).

A cluster mesh is met through the set that the program routes each
population of rays to (``mesh_set``): round 0 the fine proxy set, later
rounds the LOD set, shadow rays the shadow set, each from its
``t_bias``, by default.

Nearest-hit rules: per table the first row among equal nearest t; the
tables merge in the order spheres, boxes, rects, cylinders, disks,
planes, triangles, a later one winning only when strictly nearer; mesh
triangles count only strictly below the primitives' t + 1e-3 and take the
first of the least key in the set's triangle order. A mesh's key is its
t; a cluster mesh's, as the JAX package's cluster sweep defines it, is t
with its low log2(4 kc) mantissa bits cleared (kc: 256 triangles a
cluster for the full set, 512 for a proxy set), and its hit test allows
each barycentric down to -1e-3; the winner keeps its exact t. Dot
products sum x + y + z in that order.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from .frame import cosine_sample_hemisphere
from .scene import PROC_CELL_TINT, PROC_CHECKER

INF = 3.0e38
EPS = 1e-4
# A cluster mesh's barycentric slack (the JAX package's cluster sweep,
# ops/mesh_clusters.py: a hit where each barycentric is at least -1e-3).
CLUSTER_SLACK = 1e-3
# Ray-box tests, and ray-triangle tests, that one pass holds at once.
SLAB_CELLS = 1 << 22
PAIR_CELLS = 1 << 21
P_MAX = 1 << 62   # above every triangle position


def dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def safe_div(num, den, eps=1e-12):
    return num / torch.where(den.abs() < eps, torch.where(den < 0, -eps, eps),
                             den)


def miss(o):
    p, dt = o.shape[0], o.dtype
    z = torch.zeros((p,), dtype=dt, device=o.device)
    return SimpleNamespace(
        t=torch.full((p,), INF, dtype=dt, device=o.device),
        n=torch.zeros((p, 3), dtype=dt, device=o.device), u=z, v=z,
        mat=torch.zeros((p,), dtype=torch.int32, device=o.device),
        hit=torch.zeros((p,), dtype=torch.bool, device=o.device))


def merge(a, b):
    take = b.hit & (b.t < a.t)
    return SimpleNamespace(t=torch.where(take, b.t, a.t),
                           n=torch.where(take[:, None], b.n, a.n),
                           u=torch.where(take, b.u, a.u),
                           v=torch.where(take, b.v, a.v),
                           mat=torch.where(take, b.mat, a.mat),
                           hit=a.hit | b.hit)


def col(v, o):
    """A scalar or (P,) bound as (P, 1) in the rays' dtype."""
    return torch.as_tensor(v, dtype=o.dtype,
                           device=o.device).expand(o.shape[0])[:, None]


def first_min(t):
    """(P, N) candidate t -> (nearest t, first row at it, hit)."""
    idx = torch.argmin(t, dim=1)
    best = t.gather(1, idx[:, None])[:, 0]
    return best, idx, best < INF


def pick(pn, idx):
    return pn.gather(1, idx[:, None])[:, 0]


def flip_against(nrm, d):
    return torch.where((dot3(nrm, d) < 0)[:, None], nrm, -nrm)


def axis_normal(ax, d):
    d_axis = d.gather(1, ax[:, None])[:, 0]
    return torch.nn.functional.one_hot(ax, 3).to(d.dtype) \
        * torch.where(d_axis < 0, 1.0, -1.0).to(d.dtype)[:, None]


def spheres(tb, o, d, tmin, tmax):
    oc = o[:, None, :] - tb.center[None]
    half_b = dot3(oc, d[:, None, :])
    c = dot3(oc, oc) - (tb.radius * tb.radius)[None]
    disc = half_b * half_b - c
    s = torch.sqrt(torch.clamp(disc, min=0.0))
    t_near, t_far = -half_b - s, -half_b + s
    near_ok = (t_near >= tmin) & (t_near <= tmax)
    far_ok = (t_far >= tmin) & (t_far <= tmax)
    t = torch.where(near_ok, t_near, t_far)
    t = torch.where((disc >= 0.0) & (near_ok | far_ok), t, INF)
    best, idx, hit = first_min(t)
    inv_r = 1.0 / torch.clamp(tb.radius, min=1e-20)
    n = (o + best[:, None] * d - tb.center[idx]) * inv_r[idx][:, None]
    z = torch.zeros_like(best)
    return SimpleNamespace(t=best, n=n, u=z, v=z, mat=tb.mat[idx], hit=hit)


def face_uv(p, ax, lo, hi):
    fa = torch.where(ax == 0, 1, 0)[:, None]
    fb = torch.where(ax == 2, 1, 2)[:, None]
    g = lambda x, f: x.gather(1, f)[:, 0]
    return (safe_div(g(p, fa) - g(lo, fa), g(hi, fa) - g(lo, fa)),
            safe_div(g(p, fb) - g(lo, fb), g(hi, fb) - g(lo, fb)))


def boxes(tb, o, d, tmin, tmax):
    """Slab test: the entry face, or the exit face from inside."""
    inv_d = safe_div(torch.ones_like(d), d)
    ta = (tb.bmin[None] - o[:, None, :]) * inv_d[:, None, :]
    tc = (tb.bmax[None] - o[:, None, :]) * inv_d[:, None, :]
    tn, tf = torch.minimum(ta, tc), torch.maximum(ta, tc)
    t0, t1 = tn.amax(-1), tf.amin(-1)
    enter_ok = (t0 <= t1) & (t0 >= tmin) & (t0 <= tmax)
    exit_ok = (t0 <= t1) & (t1 >= tmin) & (t1 <= tmax)
    t = torch.where(enter_ok, t0, t1)
    axis = torch.where(enter_ok, tn.argmax(-1), tf.argmin(-1))
    best, idx, hit = first_min(torch.where(enter_ok | exit_ok, t, INF))
    ax = pick(axis, idx)
    u, v = face_uv(o + best[:, None] * d, ax, tb.bmin[idx], tb.bmax[idx])
    return SimpleNamespace(t=best, n=axis_normal(ax, d), u=u, v=v,
                           mat=tb.mat[idx], hit=hit)


def rects(tb, o, d, tmin, tmax):
    axis = tb.axis.long()
    fa = torch.where(axis == 0, 1, 0)
    fb = torch.where(axis == 2, 1, 2)
    d_ax = d[:, axis]
    ad = d_ax.abs()
    safe = torch.where(ad < 1e-8, torch.where(d_ax < 0, -1e-8, 1e-8), d_ax)
    t = (tb.k[None] - o[:, axis]) / safe
    pu = o[:, fa] + t * d[:, fa]
    pv = o[:, fb] + t * d[:, fb]
    ok = ((ad >= 1e-8) & (t >= tmin) & (t <= tmax)
          & (pu >= tb.u0[None]) & (pu <= tb.u1[None])
          & (pv >= tb.v0[None]) & (pv <= tb.v1[None]))
    best, idx, hit = first_min(torch.where(ok, t, INF))
    u = safe_div(pick(pu, idx) - tb.u0[idx], tb.u1[idx] - tb.u0[idx])
    v = safe_div(pick(pv, idx) - tb.v0[idx], tb.v1[idx] - tb.v0[idx])
    return SimpleNamespace(t=best, n=axis_normal(axis[idx], d), u=u, v=v,
                           mat=tb.mat[idx], hit=hit)


def cylinders(tb, o, d, tmin, tmax):
    """Capped Y cylinders: the nearer side root in range, else the far
    one; a cap wins only when nearer still."""
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
    inv_a = safe_div(torch.ones_like(a), a)
    quad_ok = (a > 1e-12) & (disc >= 0.0)

    def side(t):
        y = oy + t * dy
        return (quad_ok & (t > tmin) & (t < tmax)
                & (y >= tb.ymin[None]) & (y <= tb.ymax[None]))

    t1, t2 = (-half_b - s) * inv_a, (-half_b + s) * inv_a
    v1 = side(t1)
    v2 = side(t2) & ~v1
    t_cur = torch.where(v1, t1, torch.where(v2, t2, INF))
    cap_possible = tb.capped[None] & (dy.abs() > 1e-8)

    def cap(ky, t_cur):
        t = safe_div(ky[None] - oy, dy)
        rx, rz = ox + t * dx, oz + t * dz
        ok = (cap_possible & (t > tmin) & (t < tmax)
              & (rx * rx + rz * rz <= r2) & (t < t_cur))
        return torch.where(ok, t, t_cur), ok

    t_cur, top_ok = cap(tb.ymax, t_cur)
    t_cur, bot_ok = cap(tb.ymin, t_cur)
    best, idx, hit = first_min(
        torch.where(v1 | v2 | top_ok | bot_ok, t_cur, INF))
    is_top, is_bot = pick(top_ok & ~bot_ok, idx), pick(bot_ok, idx)
    inv_r = (1.0 / torch.clamp(tb.radius, min=1e-20))[idx]
    px, pz = o[:, 0] + best * d[:, 0], o[:, 2] + best * d[:, 2]
    zero = torch.zeros_like(px)
    n_side = torch.stack([(px - tb.cx[idx]) * inv_r, zero,
                          (pz - tb.cz[idx]) * inv_r], -1)
    ny = torch.where(is_top, 1.0, torch.where(is_bot, -1.0, 0.0)).to(o.dtype)
    n = torch.where((is_top | is_bot)[:, None],
                    torch.stack([zero, ny, zero], -1), n_side)
    n = torch.where((dot3(n, d) >= 0.0)[:, None], -n, n)
    return SimpleNamespace(t=best, n=n, u=zero, v=zero, mat=tb.mat[idx],
                           hit=hit)


def disks(tb, o, d, tmin, tmax):
    """The radius test takes the XZ distance only (the disks face +Y)."""
    nrm = tb.normal[None]
    denom = dot3(d[:, None, :], nrm)
    ad = denom.abs()
    safe = torch.where(ad < 1e-8, torch.where(denom < 0, -1e-8, 1e-8), denom)
    t = (dot3(tb.normal, tb.center)[None] - dot3(o[:, None, :], nrm)) / safe
    ex = o[:, 0:1] + t * d[:, 0:1] - tb.center[None, :, 0]
    ez = o[:, 2:3] + t * d[:, 2:3] - tb.center[None, :, 2]
    ok = ((ad >= 1e-6) & (t >= tmin) & (t <= tmax)
          & (ex * ex + ez * ez <= (tb.radius * tb.radius)[None]))
    best, idx, hit = first_min(torch.where(ok, t, INF))
    z = torch.zeros_like(best)
    return SimpleNamespace(t=best, n=flip_against(tb.normal[idx], d), u=z,
                           v=z, mat=tb.mat[idx], hit=hit)


def planes(tb, o, d, tmin, tmax):
    nrm = tb.normal[None]
    denom = dot3(d[:, None, :], nrm)
    t = safe_div(tb.d[None] - dot3(o[:, None, :], nrm), denom)
    ok = (denom.abs() >= 1e-6) & (t >= tmin) & (t <= tmax)
    best, idx, hit = first_min(torch.where(ok, t, INF))
    z = torch.zeros_like(best)
    return SimpleNamespace(t=best, n=flip_against(tb.normal[idx], d), u=z,
                           v=z, mat=tb.mat[idx], hit=hit)


def _moller_trumbore(a, e1, e2, o, d):
    """Double-sided Möller–Trumbore of rays ``o``, ``d`` (P, 1, 3) against
    triangles ``a``, ``e1``, ``e2`` (P or 1, N, 3): (det, u, v, t) each
    (P, N)."""
    h = cross3(d, e2)
    det = dot3(e1, h)
    inv_det = safe_div(torch.ones_like(det), det)
    s = o - a
    u = dot3(s, h) * inv_det
    q = cross3(s, e1)
    return det, u, dot3(d, q) * inv_det, dot3(e2, q) * inv_det


def _in_triangle(det, u, v):
    return ((det.abs() >= 1e-8) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
            & (u + v <= 1.0))


def _in_cluster_triangle(det, u, v):
    """A cluster mesh's hit test: each barycentric at least -1e-3."""
    return ((det.abs() >= 1e-8) & (u >= -CLUSTER_SLACK)
            & (v >= -CLUSTER_SLACK) & ((1.0 - u) - v >= -CLUSTER_SLACK))


def triangles(tb, o, d, tmin, tmax):
    det, u, v, t = _moller_trumbore(tb.a[None], tb.e1[None], tb.e2[None],
                                    o[:, None], d[:, None])
    ok = _in_triangle(det, u, v) & (t >= tmin) & (t <= tmax)
    best, idx, hit = first_min(torch.where(ok, t, INF))
    return SimpleNamespace(t=best, n=flip_against(tb.n[idx], d),
                           u=pick(u, idx), v=pick(v, idx), mat=tb.mat[idx],
                           hit=hit)


def _slab(lo, hi, o, d, tmin, tclip):
    """Rays whose segment [tmin, tclip] may meet the box [lo, hi] (the
    last dimension holds x, y, z; the others broadcast)."""
    t1, t2 = (lo - o) / d, (hi - o) / d
    flat = d == 0.0
    inside = (o >= lo) & (o <= hi)
    t1 = torch.where(flat, -INF, t1)
    t2 = torch.where(flat, INF, t2)
    near = torch.minimum(t1, t2).amax(-1)
    far = torch.maximum(t1, t2).amin(-1)
    return ((near <= far) & (far >= tmin) & (near <= tclip)
            & ~(flat & ~inside).any(-1))


def _key(t, kc):
    """The nearest-hit key of float32 ``t``: for a cluster set of ``kc``
    triangles a cluster, t with its low log2(4 kc) mantissa bits cleared;
    t itself for a mesh that is not a cluster mesh."""
    if kc is None:
        return t
    return (t.view(torch.int32) & ~(4 * kc - 1)).view(torch.float32)


def mesh(tb, o, d, tmin, tclip):
    """The mesh triangle of least key (``_key``) with tmin <= t < tclip,
    the first of equal keys in the triangle order, with its own t; the
    normal faces the ray. A cluster mesh's triangles are met by
    ``_in_cluster_triangle``, any other's by ``_in_triangle``. A mesh
    object is tested only against the rays that meet its padded
    box, and each of its spatial groups only against those of them that
    meet the group's padded box: a ray that misses a box misses its
    triangles, so the answer is that of testing every triangle."""
    P = o.shape[0]
    # The dtype of the Moller-Trumbore terms: safe_div's bounds are
    # default-dtype tensors.
    dt = torch.promote_types(torch.promote_types(o.dtype, d.dtype),
                             torch.promote_types(tb.a.dtype,
                                                 torch.get_default_dtype()))
    best = torch.full((P,), INF, dtype=dt, device=o.device)
    first = torch.full((P,), -1, dtype=torch.int64, device=o.device)
    bkey = best.clone()
    bu, bv = torch.zeros_like(best), torch.zeros_like(best)
    inside = _in_triangle if tb.kc is None else _in_cluster_triangle
    for ob in tb.objects:
        g = ob.groups
        rays = torch.nonzero(_slab(ob.lo, ob.hi, o, d, tmin, tclip))[:, 0]
        step = max(1, SLAB_CELLS // g.lo.shape[0])
        for s in range(0, rays.shape[0], step):
            r = rays[s:s + step]
            pr, pg = torch.nonzero(_slab(
                g.lo[None], g.hi[None], o[r, None], d[r, None],
                tmin[r, None], tclip[r, None]), as_tuple=True)
            chunk = max(1, PAIR_CELLS // g.idx.shape[1])
            for c in range(0, pr.shape[0], chunk):
                ray, grp = r[pr[c:c + chunk]], pg[c:c + chunk]
                det, u, v, t = _moller_trumbore(
                    g.a[grp], g.e1[grp], g.e2[grp], o[ray, None],
                    d[ray, None])
                ok = (inside(det, u, v) & (t >= tmin[ray, None])
                      & (t < tclip[ray, None]))
                t = t.to(dt)   # a key is taken of float32 t
                gk, gi, ghit = first_min(torch.where(ok, _key(t, tb.kc),
                                                     INF))
                gt = pick(t, gi)
                idx = g.idx[grp, gi]
                # Of each ray's pairs, the least key, then the first.
                near = best.new_full((P,), INF).scatter_reduce(
                    0, ray, gk, "amin")
                cand = ghit & (gk == near[ray])
                low = first.new_full((P,), P_MAX).scatter_reduce(
                    0, ray, torch.where(cand, idx, P_MAX), "amin")
                w = torch.nonzero(cand & (idx == low[ray]))[:, 0]
                rw = ray[w]
                w = w[(gk[w] < bkey[rw]) | ((gk[w] == bkey[rw])
                                           & (idx[w] < first[rw]))]
                rw = ray[w]
                bkey[rw], best[rw], first[rw] = gk[w], gt[w], idx[w]
                bu[rw], bv[rw] = pick(u[w], gi[w]), pick(v[w], gi[w])
    hit = first >= 0
    k = first.clamp(min=0)
    nrm = torch.where(hit[:, None], tb.n[k], 0.0)
    nrm = torch.where((dot3(nrm, d) >= 0.0)[:, None], -nrm, nrm)
    return SimpleNamespace(
        t=best, n=nrm, u=bu, v=bv,
        mat=torch.where(hit, tb.mat[k], 0).to(torch.int32), hit=hit)


INTERSECTORS = (("spheres", spheres), ("boxes", boxes), ("rects", rects),
                ("cylinders", cylinders), ("disks", disks),
                ("planes", planes), ("triangles", triangles))


def mesh_set(scene, cfg, population: str):
    """The mesh set that rays of ``population`` meet: "primary" (round
    0), "bounce" (every later round) or "shadow". As the program routes
    them: with ``secondary_mesh_lod`` shadow rays meet the shadow proxy
    set, else the LOD set, and later rounds the LOD set; with
    ``primary_mesh_lod`` round 0 meets the fine set; each only where the
    scene has it, the full mesh otherwise (None: no mesh)."""
    lod = scene.mesh_lod is not None and cfg["secondary_mesh_lod"]
    if population == "shadow" and lod and scene.mesh_shadow is not None:
        return scene.mesh_shadow
    if population != "primary" and lod:
        return scene.mesh_lod
    if population == "primary" and scene.mesh_fine is not None \
            and cfg["primary_mesh_lod"]:
        return scene.mesh_fine
    return scene.mesh


def intersect(scene, o, d, tmin, tmax, mesh_tb):
    """The nearest hit over the primitive tables and the mesh set
    ``mesh_tb`` (``mesh_set``), which the rays start at its ``t_bias``
    at the least."""
    h = miss(o)
    lo, hi = col(tmin, o), col(tmax, o)
    for name, fn in INTERSECTORS:
        tb = getattr(scene, name)
        if tb.mat.shape[0]:
            h = merge(h, fn(tb, o, d, lo, hi))
    if mesh_tb is not None:
        tclip = torch.minimum(hi[:, 0], h.t + 1e-3)
        start = lo[:, 0].contiguous()
        if mesh_tb.t_bias > 0.0:
            start = torch.clamp(start, min=mesh_tb.t_bias)
        h = merge(h, mesh(mesh_tb, o, d, start, tclip))
    return h


def gather(table, mat_id):
    idx = mat_id.long()
    return SimpleNamespace(**{k: v[idx] for k, v in vars(table).items()})


def _i32(x: int) -> int:
    return x - (1 << 32) if x >= 1 << 31 else x


def albedo_at(m, pos, tint_pos):
    """Solid, world-XZ checker and per-cell tint surfaces."""
    cx = torch.floor(pos[..., 0] / m.proc_scale).to(torch.int32)
    cz = torch.floor(pos[..., 2] / m.proc_scale).to(torch.int32)
    checker = torch.where((((cx + cz) & 1) == 0)[..., None], m.albedo,
                          m.albedo2)
    out = torch.where((m.proc == PROC_CHECKER)[..., None], checker, m.albedo)
    q = [torch.floor(tint_pos[..., i] / m.proc_scale).to(torch.int32)
         for i in range(3)]
    h = ((q[0] * _i32(0x27D4EB2F)) ^ (q[1] * _i32(0x9E3779B1))
         ^ (q[2] * _i32(0x85EBCA6B)))
    h = h ^ (h >> 15)
    h = h * _i32(0x165667B1)
    h = h ^ (h >> 13)
    tint = 1.0 + 0.08 * (torch.remainder(h.abs(), 5).to(pos.dtype) - 2.0)
    return torch.where((m.proc == PROC_CELL_TINT)[..., None],
                       torch.clamp(m.albedo * tint[..., None], 0.0, 1.0), out)


def reflect(v, n):
    return v - n * (2.0 * dot3(v, n))[..., None]


def refract(v, n, eta):
    cosi = -torch.clamp(dot3(v, n), -1.0, 1.0)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    d = v * eta[..., None] \
        + n * (eta * cosi - torch.sqrt(torch.clamp(k, min=0.0)))[..., None]
    return k >= 0.0, d


def normalize(v):
    return v / torch.sqrt(torch.clamp(dot3(v, v), min=1e-20))[..., None]


def fresnel(cos_theta, eta_i, eta_t):
    r = (eta_i - eta_t) / (eta_i + eta_t)
    r0 = r * r
    x = 1.0 - cos_theta
    x2 = x * x
    return r0 + (1.0 - r0) * (x * (x2 * x2))


def oren_nayar(albedo, n, wo, wi, sigma_rad: float):
    cos_i = torch.clamp(dot3(n, wi), min=0.0)
    cos_o = torch.clamp(dot3(n, wo), min=0.0)
    sin_i = torch.sqrt(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    sin_o = torch.sqrt(torch.clamp(1.0 - cos_o * cos_o, min=0.0))
    proj_i = normalize(wi - n * cos_i[..., None])
    proj_o = normalize(wo - n * cos_o[..., None])
    cos_phi = torch.clamp(dot3(proj_i, proj_o), min=0.0)
    s2 = sigma_rad * sigma_rad
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)
    tan_beta = torch.minimum(sin_i / torch.clamp(cos_i, min=1e-6),
                             sin_o / torch.clamp(cos_o, min=1e-6))
    on = a + b * cos_phi * torch.maximum(sin_i, sin_o) * tan_beta
    f = albedo * (on * (1.0 / math.pi))[..., None]
    zero = (cos_i <= 0.0) | (cos_o <= 0.0)
    return torch.where(zero[..., None], 0.0, torch.clamp(f, 0.0, 1.0))


def transmittance(scene, so, sd, max_dist, need, cfg):
    """Coloured transmittance along shadow rays through up to
    ``max_refractions`` transparent hits; (R, 3) and rays traced (R,)."""
    so = torch.where(need[:, None], so, 2.9e30)
    trans = torch.ones_like(so)
    done = torch.zeros_like(need)
    tmin = torch.full_like(max_dist, EPS)
    rays = torch.zeros(need.shape, dtype=torch.int32, device=so.device)
    mesh_tb = mesh_set(scene, cfg, "shadow")
    for _ in range(cfg["max_refractions"]):
        live = need & ~done
        if not bool(live.any()):
            break
        rays = rays + live.to(torch.int32)
        h = intersect(scene, so, sd, tmin, max_dist, mesh_tb)
        m = gather(scene.materials, h.mat)
        opaque = h.hit & (m.transparency <= 0.0) & ~done
        trans = torch.where(opaque[:, None], 0.0, trans)
        through = h.hit & (m.transparency > 0.0) & ~done
        trans = torch.where(through[:, None],
                            trans * (m.transmission * m.transparency[:, None]),
                            trans)
        done = done | ~h.hit | opaque | (trans <= 1e-6).all(-1)
        tmin = torch.where(done, tmin, h.t + EPS)
    trans = torch.where((trans <= 1e-6).all(-1, keepdim=True), 0.0, trans)
    return trans, rays


def trace_pixels(scene, o0, d0, rng0, cfg):
    """Every pixel's path tree. Returns (P, 12) columns: radiance (3),
    sky, albedo (3), normal (3), depth, rays traced."""
    P, dev, dt = o0.shape[0], o0.device, o0.dtype
    S = min(cfg["path_stack_size"], cfg["max_mirror_bounces"] + 1)
    sigma = cfg["diffuse_sigma_deg"] * math.pi / 180.0
    f3 = lambda: torch.zeros((P, 3), dtype=dt, device=dev)
    i1 = lambda: torch.zeros(P, dtype=torch.int32, device=dev)
    b1 = lambda v: torch.full((P,), v, dtype=torch.bool, device=dev)
    o, d, beta = o0, d0, torch.ones((P, 3), dtype=dt, device=dev)
    mirror, diffuse, active, rng = i1(), i1(), b1(True), rng0
    radiance, lane_rays = f3(), i1()
    is_primary, primary_hit, is_sky, g_valid = b1(True), b1(False), \
        b1(False), b1(False)
    g_albedo, g_normal = f3(), f3()
    g_depth = torch.full((P,), INF, dtype=dt, device=dev)
    stack = scene.any_transparent
    sp = i1()
    st_o, st_d, st_beta = (torch.zeros((S, P, 3), dtype=dt, device=dev)
                           for _ in range(3))
    st_mirror, st_diffuse = (torch.zeros((S, P), dtype=torch.int32,
                                         device=dev) for _ in range(2))
    slot = torch.arange(S, device=dev)[:, None]
    lt = scene.lights
    L = lt.pos.shape[0]
    amb = scene.ambient_color * scene.ambient_intensity
    lanes = torch.arange(P, device=dev)

    for rnd in range(cfg["max_trace_rounds"]):
        if not bool(active.any()):
            break
        lane_rays = lane_rays + active.to(torch.int32)
        h = intersect(scene, torch.where(active[:, None], o, 2.9e30), d,
                      1e-3, INF,
                      mesh_set(scene, cfg, "bounce" if rnd else "primary"))
        m = gather(scene.materials, h.mat)
        p = o + h.t[:, None] * d
        alb = albedo_at(m, p, p + d * 1e-3)

        miss = active & ~h.hit
        tbg = 0.5 * (d[:, 1] + 1.0)
        sky = scene.bg_bottom * (1.0 - tbg[:, None]) \
            + scene.bg_top * tbg[:, None]
        radiance = radiance + torch.where(miss[:, None], beta * sky, 0.0)
        hit_now = active & h.hit

        primary_miss = miss & is_primary & ~primary_hit
        is_sky = is_sky | primary_miss
        g_valid = g_valid | primary_miss
        primary_now = hit_now & is_primary
        primary_hit = primary_hit | primary_now
        fill = primary_now & ~g_valid
        g_albedo = torch.where(fill[:, None], alb, g_albedo)
        g_normal = torch.where(fill[:, None], h.n, g_normal)
        g_depth = torch.where(fill, h.t, g_depth)
        g_valid = g_valid | fill
        is_primary = is_primary & ~hit_now

        radiance = radiance + torch.where(hit_now[:, None],
                                          beta * m.emission, 0.0)
        transparent = hit_now & (m.transparency > 0.0)
        can_bounce = mirror < cfg["max_mirror_bounces"]
        is_mirror = (hit_now & ~transparent
                     & (m.reflectivity >= cfg["mirror_threshold"]))
        is_diffuse = hit_now & ~transparent & ~is_mirror
        n = h.n

        if stack:
            tr = transparent & can_bounce
            front = dot3(n, d) < 0.0
            nl = torch.where(front[:, None], n, -n)
            one = torch.ones_like(m.ior)
            eta_i = torch.where(front, one, m.ior)
            eta_t = torch.where(front, m.ior, one)
            refl_dir = normalize(reflect(d, nl))
            has_refr, refr_dir = refract(d, nl, eta_i / eta_t)
            fres = fresnel(dot3(nl, -d).abs(), eta_i, eta_t)
            t_w = torch.where(has_refr, (1.0 - fres)
                              * torch.clamp(m.transparency, 0.0, 1.0), 0.0)
            r_w = torch.clamp(fres + m.reflectivity * (1.0 - fres), 0.0, 1.0)
            for mask, io, idir, ib in (
                    (tr & (r_w > 0.0), p + nl * EPS, refl_dir,
                     beta * alb * r_w[:, None]),
                    (tr & (t_w > 0.0), p - nl * EPS, normalize(refr_dir),
                     beta * m.transmission * t_w[:, None])):
                mask = mask & (sp < S)
                sel = (slot == sp[None, :]) & mask[None, :]
                st_o = torch.where(sel[..., None], io[None], st_o)
                st_d = torch.where(sel[..., None], idir[None], st_d)
                st_beta = torch.where(sel[..., None], ib[None], st_beta)
                st_mirror = torch.where(sel, (mirror + 1)[None], st_mirror)
                st_diffuse = torch.where(sel, diffuse[None], st_diffuse)
                sp = sp + mask.to(torch.int32)

        wo = -d
        radiance = radiance + torch.where(is_diffuse[:, None],
                                          beta * (amb * alb), 0.0)
        if L:
            to_l = lt.pos[None] - p[:, None, :]
            dist2 = torch.clamp(dot3(to_l, to_l), min=1e-12)
            dist = torch.sqrt(dist2)
            ldir = to_l / dist[..., None]
            ndotl = torch.clamp(dot3(n[:, None, :], ldir), min=0.0)
            need = (is_diffuse[:, None] & (ndotl > 0.0)
                    & (lt.intensity[None] > 0.0))
            W = P
            so = (p + n * EPS)[:, None, :].expand(W, L, 3)
            trans, shadow_rays = transmittance(
                scene, so.reshape(W * L, 3), ldir.reshape(W * L, 3),
                (dist - EPS).reshape(W * L), need.reshape(W * L), cfg)
            trans = trans.reshape(W, L, 3)
            lane_rays = lane_rays + shadow_rays.reshape(W, L).sum(
                1, dtype=torch.int32)
            f_on = oren_nayar(alb[:, None, :], n[:, None, :], wo[:, None, :],
                              ldir, sigma)
            contrib = (f_on * ndotl[..., None] * lt.color[None]
                       * (lt.intensity[None] / dist2)[..., None] * trans)
            contrib = torch.where(need[..., None], contrib, 0.0)
            radiance = radiance + beta * contrib.sum(1)

        want_bounce = is_diffuse & (diffuse < cfg["diffuse_bounces"])
        new_rng, bounce_dir = cosine_sample_hemisphere(n, rng)
        rng = torch.where(want_bounce, new_rng, rng)
        bounce_beta = beta * oren_nayar(alb, n, wo, bounce_dir, sigma) \
            * math.pi

        mirror_cont = is_mirror & can_bounce
        cont = mirror_cont | want_bounce
        c3, m3 = cont[:, None], mirror_cont[:, None]
        o = torch.where(c3, p + n * EPS, o)
        d = torch.where(c3, torch.where(m3, normalize(reflect(d, n)),
                                        bounce_dir), d)
        beta = torch.where(c3, torch.where(m3, beta * alb, bounce_beta), beta)
        mirror = mirror + mirror_cont.to(torch.int32)
        diffuse = diffuse + want_bounce.to(torch.int32)
        ended = active & ~cont
        if stack:
            pop = ended & (sp > 0)
            top = torch.clamp(sp - 1, min=0).long()
            o = torch.where(pop[:, None], st_o[top, lanes], o)
            d = torch.where(pop[:, None], st_d[top, lanes], d)
            beta = torch.where(pop[:, None], st_beta[top, lanes], beta)
            mirror = torch.where(pop, st_mirror[top, lanes], mirror)
            diffuse = torch.where(pop, st_diffuse[top, lanes], diffuse)
            sp = sp - pop.to(torch.int32)
            active = active & (cont | pop)
        else:
            active = active & cont

    return torch.cat([radiance, is_sky.to(dt)[:, None], g_albedo, g_normal,
                      g_depth[:, None], lane_rays.to(dt)[:, None]], dim=1)
