"""Wavefront path tracing: the plain version of the trace kernel, and the
trace of cluster-mesh scenes.

Port of ``yetanotherconsolegameengine_tpu/ops/trace.py::trace_all``: every
pixel carries (ray, throughput, depth counters, a path stack, an RNG state)
and one round — intersect, sky / emission, refraction push / mirror
continue / diffuse shade + bounce, pop — runs for all pixels at once until
every stack is empty. Shading is Oren–Nayar direct light with
inverse-square falloff, Schlick-Fresnel reflect+refract splitting, colored
shadow transmittance through up to ``max_refractions`` transparent hits,
the zero-intensity light gate, and the sky gradient.

For primitive scenes the per-pixel loop of ``ops/csrc/trace_kernel.cu``
computes the same thing in the same arithmetic order; this module is what
it is held against. Every scene the trace kernel does not take
(``trace_kernel.scene_fits``: meshes, textures, tables too large for a
block) traces here on every device. Surfaces are shaded from the hit's
u, v, the scene's texture bank and a point just inside the surface for
the per-cell tint. Cluster-mesh scenes take the mesh parts of the JAX
module: round 0 sweeps the fine proxy set and later rounds the LOD set,
shadow rays the shadow set in light-major lane order, and between rounds
the wavefront compacts to its active lanes (``WAVEFRONT_COMPACTION``);
BVH-mesh and primitive scenes do neither, as in the JAX module. ``impl``
picks the cluster sweep: "kernel" (K3) or "plain"; None picks from the
rays' device (``devices.resolve_impl``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..config import RenderConfig
from ..core import sampler
from ..devices import resolve_impl
from ..scene.materials import gather_material, sample_albedo
from ..utils import profiling
from .intersect import INF, dot3, intersect_scene

EPS = 1e-4

# Ablation knob for the provable stack-depth clamp: the clamped stack must
# give bit-identical results to the full cfg.path_stack_size stack.
STACK_CLAMP = True

# Between-round wavefront compaction of cluster-mesh scenes, at every size.
# Tests turn it off for the reference the compacted loop must equal.
WAVEFRONT_COMPACTION = True


def reflect(v, n):
    return v - n * (2.0 * dot3(v, n))[..., None]


def refract(v, n, eta):
    """Snell refraction; returns (has_refract, dir)."""
    cosi = -torch.clamp(dot3(v, n), -1.0, 1.0)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    d = v * eta[..., None] \
        + n * (eta * cosi - torch.sqrt(torch.clamp(k, min=0.0)))[..., None]
    return k >= 0.0, d


def pow5(x):
    """x**5 in the multiplication order XLA's integer_pow uses."""
    x2 = x * x
    return x * (x2 * x2)


def fresnel_schlick(cos_theta, eta_i, eta_t):
    r = (eta_i - eta_t) / (eta_i + eta_t)
    r0 = r * r
    return r0 + (1.0 - r0) * pow5(1.0 - cos_theta)


def normalize(v):
    return v / torch.sqrt(torch.clamp(dot3(v, v), min=1e-20))[..., None]


def oren_nayar(albedo, n, wo, wi, sigma_rad: float):
    """Oren–Nayar diffuse BRDF, clipped to [0, 1] per channel."""
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
    sin_alpha = torch.maximum(sin_i, sin_o)
    tan_beta = torch.minimum(sin_i / torch.clamp(cos_i, min=1e-6),
                             sin_o / torch.clamp(cos_o, min=1e-6))
    on = a + b * cos_phi * sin_alpha * tan_beta
    f = albedo * (on * (1.0 / math.pi))[..., None]
    zero = (cos_i <= 0.0) | (cos_o <= 0.0)
    return torch.where(zero[..., None], 0.0, torch.clamp(f, 0.0, 1.0))


def transmittance_to_lights(scene, so, sd, max_dist, need, cfg: RenderConfig,
                            lod: bool = False, presort=None,
                            impl=None):
    """Colored transmittance along shadow rays (binary occlusion when the
    scene asks for binary shadows). so/sd: (R, 3); max_dist, need: (R,).
    ``lod`` sends the mesh sweep to the shadow / LOD proxy set; ``presort``
    (default ``cfg.presort_shadow``) bins the rays first. Each sweep counts
    in the tracer's ``wavefront.shadow_sweeps``.
    Returns ((R, 3) transmittance, (R,) int32 traced shadow rays per lane)."""
    impl = resolve_impl(impl, so.device)
    so = torch.where(need[:, None], so, 2.9e30)
    if presort is None:
        presort = cfg.presort_shadow
    sweep = dict(shadow=True, lod=lod, presort=presort, impl=impl)
    if scene.binary_shadows:
        profiling.count("wavefront.shadow_sweeps")
        h = intersect_scene(scene, so, sd, 1e-3, max_dist, **sweep)
        return (torch.where(h.hit[:, None], 0.0, torch.ones_like(so)),
                need.to(torch.int32))
    trans = torch.ones_like(so)
    done = torch.zeros_like(need)
    tmin = torch.full_like(max_dist, EPS)
    rays = torch.zeros(need.shape, dtype=torch.int32, device=so.device)
    for _ in range(cfg.max_refractions):
        live = need & ~done
        if not profiling.sync("trace.shadow_live", bool, live.any()):
            break
        rays = rays + live.to(torch.int32)
        profiling.count("wavefront.shadow_sweeps")
        h = intersect_scene(scene, so, sd, tmin, max_dist, **sweep)
        m = gather_material(scene.materials, h.mat)
        opaque = h.hit & (m.transparency <= 0.0) & ~done
        trans = torch.where(opaque[:, None], 0.0, trans)
        through = h.hit & (m.transparency > 0.0) & ~done
        tint = m.transmission * m.transparency[:, None]
        trans = torch.where(through[:, None], trans * tint, trans)
        faded = (trans <= 1e-6).all(-1)
        done = done | ~h.hit | opaque | faded
        tmin = torch.where(done, tmin, h.t + EPS)
    trans = torch.where((trans <= 1e-6).all(-1, keepdim=True), 0.0, trans)
    return trans, rays


@dataclasses.dataclass(frozen=True)
class TraceResult:
    radiance: torch.Tensor     # (P, 3) linear HDR
    is_sky: torch.Tensor       # (P,) bool
    albedo: torch.Tensor       # (P, 3) G-buffer
    normal: torch.Tensor       # (P, 3)
    depth: torch.Tensor        # (P,) INF where the primary ray missed
    rays_traced: torch.Tensor  # () int64 — primary + bounce + shadow rays
    lane_rays: torch.Tensor    # (P,) int32 — the same count per pixel


def stack_slots(cfg: RenderConfig) -> int:
    """Path-stack depth. A refraction event pushes two children and pops
    one back the same round, and pushes need mirror < max_mirror_bounces,
    so the stack never holds more than max_mirror_bounces + 1 items."""
    return (min(cfg.path_stack_size, cfg.max_mirror_bounces + 1)
            if STACK_CLAMP else cfg.path_stack_size)


# Lane state that rounds after round 0 read and write; the G-buffer keys
# (is_primary, primary_hit, is_sky, g_*) change only in round 0.
_CARRY = ("o", "d", "beta", "mirror", "diffuse", "active", "rng",
          "radiance", "lane_rays", "sp")
_STACK = ("st_o", "st_d", "st_beta", "st_mirror", "st_diffuse")  # (S, P, ...)


def _compact(full: dict, cur: dict, lanes):
    """Gather ``cur``'s active lanes into a new sub-wavefront. ``lanes``
    maps ``cur``'s lanes to ``full``'s (None: ``cur`` is ``full``); the
    outputs of ``cur`` are written back first. Waits on the host once."""
    keep = profiling.sync("trace.compact", torch.nonzero, cur["active"])[:, 0]
    if lanes is not None:
        _write_back(full, cur, lanes)
    sub = {k: cur[k][keep] for k in _CARRY if k in cur}
    sub.update({k: cur[k][:, keep] for k in _STACK if k in cur})
    return sub, keep if lanes is None else lanes[keep]


def _write_back(full: dict, cur: dict, lanes) -> None:
    for k in ("radiance", "lane_rays"):
        full[k].index_copy_(0, lanes, cur[k])


def trace_all(scene, o0, d0, rng0, cfg: RenderConfig,
              impl=None) -> TraceResult:
    """Trace every pixel's full path tree. o0/d0: (P, 3); rng0: (P,) int64
    SplitMix64 states. ``impl`` picks the cluster-mesh sweep."""
    P = o0.shape[0]
    dev = o0.device
    impl = resolve_impl(impl, dev)
    S = stack_slots(cfg)
    sigma_rad = cfg.diffuse_sigma_deg * math.pi / 180.0
    use_stack = scene.any_transparent
    mesh = scene.mesh_clusters is not None
    use_lod = (mesh and cfg.secondary_mesh_lod
               and scene.mesh_clusters_lod is not None)
    use_fine = (mesh and cfg.primary_mesh_lod
                and scene.mesh_clusters_fine is not None)
    f3 = lambda: torch.zeros((P, 3), device=dev)
    i1 = lambda: torch.zeros(P, dtype=torch.int32, device=dev)
    b1 = lambda v: torch.full((P,), v, dtype=torch.bool, device=dev)

    st = dict(o=o0, d=d0, beta=torch.ones((P, 3), device=dev),
              mirror=i1(), diffuse=i1(), active=b1(True), rng=rng0,
              radiance=f3(), lane_rays=i1(),
              is_primary=b1(True), primary_hit=b1(False), is_sky=b1(False),
              g_valid=b1(False), g_albedo=f3(), g_normal=f3(),
              g_depth=torch.full((P,), INF, device=dev))
    if use_stack:
        st.update(sp=i1(), st_o=torch.zeros((S, P, 3), device=dev),
                  st_d=torch.zeros((S, P, 3), device=dev),
                  st_beta=torch.zeros((S, P, 3), device=dev),
                  st_mirror=torch.zeros((S, P), dtype=torch.int32,
                                        device=dev),
                  st_diffuse=torch.zeros((S, P), dtype=torch.int32,
                                         device=dev))
    slot = torch.arange(S, device=dev)[:, None]

    lt = scene.lights
    L = lt.mask.shape[0]
    amb_rgb = scene.ambient_color * scene.ambient_intensity
    # Light-major shadow lanes: each 256-lane tile of the mesh sweep is
    # then consecutive rays toward one light, swept unsorted.
    lmaj = cfg.lmajor_shadow and L > 1 and mesh

    def body(st: dict, lod_sweep: bool) -> None:
        """One round on the lanes of ``st``, in place. ``lod_sweep``:
        a round after round 0 (the LOD set; bounce populations binned)."""
        o, d, beta, active = st["o"], st["d"], st["beta"], st["active"]
        mirror, diffuse = st["mirror"], st["diffuse"]
        W = o.shape[0]
        st["lane_rays"] = st["lane_rays"] + active.to(torch.int32)
        o_q = torch.where(active[:, None], o, 2.9e30)
        hit = intersect_scene(scene, o_q, d, 1e-3, INF,
                              lod=use_lod and lod_sweep,
                              fine=use_fine and not lod_sweep,
                              presort=lod_sweep or cfg.presort_primary,
                              impl=impl)
        m = gather_material(scene.materials, hit.mat)
        p = o + hit.t[:, None] * d
        uv = torch.stack([hit.u, hit.v], -1)
        base_albedo = sample_albedo(m, p, uv, scene.textures,
                                    tint_pos=p + d * 1e-3)

        # ---- miss: vertical sky gradient ---------------------------------
        miss = active & ~hit.hit
        tbg = 0.5 * (d[:, 1] + 1.0)
        sky = scene.bg_bottom * (1.0 - tbg[:, None]) \
            + scene.bg_top * tbg[:, None]
        st["radiance"] = st["radiance"] + torch.where(miss[:, None],
                                                      beta * sky, 0.0)
        hit_now = active & hit.hit

        # ---- primary-hit G-buffer (round 0 only: after it no active lane
        # is still primary, since popped and continued rays all hit) --------
        if not lod_sweep:
            primary_miss = miss & st["is_primary"] & ~st["primary_hit"]
            st["is_sky"] = st["is_sky"] | primary_miss
            st["g_valid"] = st["g_valid"] | primary_miss
            primary_now = hit_now & st["is_primary"]
            st["primary_hit"] = st["primary_hit"] | primary_now
            fill_g = primary_now & ~st["g_valid"]
            st["g_albedo"] = torch.where(fill_g[:, None], base_albedo,
                                         st["g_albedo"])
            st["g_normal"] = torch.where(fill_g[:, None], hit.n,
                                         st["g_normal"])
            st["g_depth"] = torch.where(fill_g, hit.t, st["g_depth"])
            st["g_valid"] = st["g_valid"] | fill_g
            st["is_primary"] = st["is_primary"] & ~hit_now

        st["radiance"] = st["radiance"] + torch.where(
            hit_now[:, None], beta * m.emission, 0.0)

        # ---- branch classification ---------------------------------------
        transparent = hit_now & (m.transparency > 0.0)
        can_bounce = mirror < cfg.max_mirror_bounces
        is_mirror = (hit_now & ~transparent
                     & (m.reflectivity >= cfg.mirror_threshold))
        is_diffuse = hit_now & ~transparent & ~is_mirror
        n = hit.n

        # ---- transparent: Fresnel-weighted reflect + refract pushes -------
        if use_stack:
            tr_act = transparent & can_bounce
            front = dot3(n, d) < 0.0
            nl = torch.where(front[:, None], n, -n)
            eta_i = torch.where(front, 1.0, m.ior)
            eta_t = torch.where(front, m.ior, 1.0)
            eta = eta_i / eta_t
            refl_dir = normalize(reflect(d, nl))
            has_refr, refr_dir = refract(d, nl, eta)
            fres = fresnel_schlick(dot3(nl, -d).abs(), eta_i, eta_t)
            tr_amt = torch.clamp(m.transparency, 0.0, 1.0)
            t_w = torch.where(has_refr, (1.0 - fres) * tr_amt, 0.0)
            r_w = torch.clamp(fres + m.reflectivity * (1.0 - fres), 0.0, 1.0)
            items = (
                (tr_act & (r_w > 0.0), p + nl * EPS, refl_dir,
                 beta * base_albedo * r_w[:, None]),
                (tr_act & (t_w > 0.0), p - nl * EPS, normalize(refr_dir),
                 beta * m.transmission * t_w[:, None]))
            for mask, item_o, item_d, item_beta in items:
                mask = mask & (st["sp"] < S)
                sel = (slot == st["sp"][None, :]) & mask[None, :]
                sel3 = sel[..., None]
                st["st_o"] = torch.where(sel3, item_o[None], st["st_o"])
                st["st_d"] = torch.where(sel3, item_d[None], st["st_d"])
                st["st_beta"] = torch.where(sel3, item_beta[None],
                                            st["st_beta"])
                st["st_mirror"] = torch.where(sel, (mirror + 1)[None],
                                              st["st_mirror"])
                st["st_diffuse"] = torch.where(sel, diffuse[None],
                                               st["st_diffuse"])
                st["sp"] = st["sp"] + mask.to(torch.int32)

        # ---- diffuse: ambient + direct lights + one cosine bounce ---------
        wo = -d
        st["radiance"] = st["radiance"] + torch.where(
            is_diffuse[:, None], beta * (amb_rgb * base_albedo), 0.0)
        if L > 0:
            to_l = lt.pos[None] - p[:, None, :]                 # (W, L, 3)
            dist2 = torch.clamp(dot3(to_l, to_l), min=1e-12)
            dist = torch.sqrt(dist2)
            ldir = to_l / dist[..., None]
            ndotl = torch.clamp(dot3(n[:, None, :], ldir), min=0.0)
            # Zero-intensity lights contribute exactly 0: no shadow rays.
            need = (is_diffuse[:, None] & lt.mask[None] & (ndotl > 0.0)
                    & (lt.intensity[None] > 0.0))
            so = (p + n * EPS)[:, None, :].expand(W, L, 3)
            smax = dist - EPS
            # The span wraps the call, not the loop's body: a profiler
            # range opened inside a range that a tool wraps around
            # transmittance_to_lights would take its kernels from it.
            with profiling.span("wavefront.shadow"):
                if lmaj:
                    trans, shadow_rays = transmittance_to_lights(
                        scene, so.transpose(0, 1).reshape(L * W, 3),
                        ldir.transpose(0, 1).reshape(L * W, 3),
                        smax.T.reshape(L * W), need.T.reshape(L * W), cfg,
                        lod=use_lod, presort=False, impl=impl)
                    trans = trans.reshape(L, W, 3).transpose(0, 1)
                    shadow_rays = shadow_rays.reshape(L, W).T
                else:
                    trans, shadow_rays = transmittance_to_lights(
                        scene, so.reshape(W * L, 3), ldir.reshape(W * L, 3),
                        smax.reshape(W * L), need.reshape(W * L), cfg,
                        lod=use_lod, impl=impl)
                    trans = trans.reshape(W, L, 3)
                    shadow_rays = shadow_rays.reshape(W, L)
            st["lane_rays"] = st["lane_rays"] + shadow_rays.sum(
                1, dtype=torch.int32)
            atten = lt.intensity[None] / dist2
            f_on = oren_nayar(base_albedo[:, None, :], n[:, None, :],
                              wo[:, None, :], ldir, sigma_rad)
            contrib = (f_on * ndotl[..., None] * lt.color[None]
                       * atten[..., None] * trans)
            contrib = torch.where(need[..., None], contrib, 0.0)
            st["radiance"] = st["radiance"] + beta * contrib.sum(1)

        want_bounce = is_diffuse & (diffuse < cfg.diffuse_bounces)
        new_rng, bounce_dir = sampler.cosine_sample_hemisphere(n, st["rng"])
        st["rng"] = torch.where(want_bounce, new_rng, st["rng"])
        f_bounce = oren_nayar(base_albedo, n, wo, bounce_dir, sigma_rad)
        bounce_beta = beta * f_bounce * math.pi

        # ---- continue in place vs pop -------------------------------------
        mirror_cont = is_mirror & can_bounce
        cont = mirror_cont | want_bounce
        c3 = cont[:, None]
        m3 = mirror_cont[:, None]
        o = torch.where(c3, p + n * EPS, o)
        d = torch.where(c3, torch.where(m3, normalize(reflect(d, n)),
                                        bounce_dir), d)
        beta = torch.where(c3, torch.where(m3, beta * base_albedo,
                                           bounce_beta), beta)
        mirror = mirror + mirror_cont.to(torch.int32)
        diffuse = diffuse + want_bounce.to(torch.int32)

        ended = active & ~cont
        if use_stack:
            sp = st["sp"]
            can_pop = ended & (sp > 0)
            top = torch.clamp(sp - 1, min=0).long()
            lanes = torch.arange(W, device=dev)
            pm = can_pop[:, None]
            o = torch.where(pm, st["st_o"][top, lanes], o)
            d = torch.where(pm, st["st_d"][top, lanes], d)
            beta = torch.where(pm, st["st_beta"][top, lanes], beta)
            mirror = torch.where(can_pop, st["st_mirror"][top, lanes], mirror)
            diffuse = torch.where(can_pop, st["st_diffuse"][top, lanes],
                                  diffuse)
            st["sp"] = sp - can_pop.to(torch.int32)
            active = active & (cont | can_pop)
        else:
            active = active & cont
        st.update(o=o, d=d, beta=beta, mirror=mirror, diffuse=diffuse,
                  active=active)

    # Round 0 on every lane; with compaction, every later round on the
    # lanes still active (gathered once per round, in lane order, so tiles
    # stay coherent). Per-lane arithmetic does not depend on the other
    # lanes, so the result equals the uncompacted loop.
    compact = WAVEFRONT_COMPACTION and mesh
    cur, lanes = st, None
    for rnd in range(cfg.max_trace_rounds):
        if compact and rnd > 0:
            cur, lanes = _compact(st, cur, lanes)
            if lanes.numel() == 0:
                break
        elif not profiling.sync("trace.round_live", bool,
                                cur["active"].any()):
            break
        body(cur, lod_sweep=rnd > 0)
    if lanes is not None:
        _write_back(st, cur, lanes)

    return TraceResult(radiance=st["radiance"], is_sky=st["is_sky"],
                       albedo=st["g_albedo"], normal=st["g_normal"],
                       depth=st["g_depth"],
                       rays_traced=st["lane_rays"].sum(dtype=torch.int64),
                       lane_rays=st["lane_rays"])
