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

A frame runs as segments with no host wait inside, cut at the host's
checks for live lanes and shadow rays. On a card, where every round has
the full width and the scene, width and config are the previous call's,
the segments replay from CUDA graphs (``_Graphs``), so the host launches
a few dozen graphs a frame instead of thousands of kernels; the arithmetic
is the eager frame's line for line.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import weakref

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

# CUDA graphs of the wavefront's segments where ``_graphs_for`` allows them.
# Tests turn it off for the eager frames the replayed ones must equal.
WAVEFRONT_GRAPHS = True


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
                            impl=None, graphs=None):
    """Colored transmittance along shadow rays (binary occlusion when the
    scene asks for binary shadows). so/sd: (R, 3); max_dist, need: (R,).
    ``lod`` sends the mesh sweep to the shadow / LOD proxy set; ``presort``
    (default ``cfg.presort_shadow``) bins the rays first. Each sweep counts
    in the tracer's ``wavefront.shadow_sweeps``. The loop runs as segments
    with no host wait inside (``shadow.start``, one ``shadow.step`` a
    sweep, ``shadow.end``); the check for live rays between them stays on
    the host. ``graphs`` (``trace_all``'s ``_Graphs``) replays them from
    CUDA graphs; None runs them eagerly.
    Returns ((R, 3) transmittance, (R,) int32 traced shadow rays per lane)."""
    impl = resolve_impl(impl, so.device)
    if presort is None:
        presort = cfg.presort_shadow
    run = _eager if graphs is None else graphs.run

    def sweep(sh, tmin):
        return intersect_scene(scene, sh["so"], sh["sd"], tmin,
                               sh["max_dist"], shadow=True, lod=lod,
                               presort=presort, impl=impl)

    def binary(sh):
        so = torch.where(sh["need"][:, None], sh["so"], 2.9e30)
        h = sweep(dict(sh, so=so), 1e-3)
        sh["trans"] = torch.where(h.hit[:, None], 0.0, torch.ones_like(so))
        sh["rays"] = sh["need"].to(torch.int32)

    def start(sh):
        need = sh["need"]
        sh["so"] = torch.where(need[:, None], sh["so"], 2.9e30)
        sh["trans"] = torch.ones_like(sh["so"])
        sh["done"] = torch.zeros_like(need)
        sh["tmin"] = torch.full_like(sh["max_dist"], EPS)
        sh["rays"] = torch.zeros(need.shape, dtype=torch.int32,
                                 device=need.device)
        sh["live"] = need & ~sh["done"]
        sh["live_any"] = sh["live"].any()

    def step(sh):
        done, trans = sh["done"], sh["trans"]
        sh["rays"] = sh["rays"] + sh["live"].to(torch.int32)
        h = sweep(sh, sh["tmin"])
        m = gather_material(scene.materials, h.mat)
        opaque = h.hit & (m.transparency <= 0.0) & ~done
        trans = torch.where(opaque[:, None], 0.0, trans)
        through = h.hit & (m.transparency > 0.0) & ~done
        tint = m.transmission * m.transparency[:, None]
        trans = torch.where(through[:, None], trans * tint, trans)
        faded = (trans <= 1e-6).all(-1)
        done = done | ~h.hit | opaque | faded
        sh["tmin"] = torch.where(done, sh["tmin"], h.t + EPS)
        sh.update(trans=trans, done=done)
        sh["live"] = sh["need"] & ~done
        sh["live_any"] = sh["live"].any()

    def end(sh):
        trans = sh["trans"]
        sh["trans"] = torch.where((trans <= 1e-6).all(-1, keepdim=True), 0.0,
                                  trans)

    sh = dict(so=so, sd=sd, max_dist=max_dist, need=need)
    if scene.binary_shadows:
        profiling.count("wavefront.shadow_sweeps")
        run("shadow.binary", binary, sh)
        return sh["trans"], sh["rays"]
    run("shadow.start", start, sh)
    for _ in range(cfg.max_refractions):
        if not profiling.sync("trace.shadow_live", bool, sh["live_any"]):
            break
        profiling.count("wavefront.shadow_sweeps")
        run("shadow.step", step, sh)
    run("shadow.end", end, sh)
    return sh["trans"], sh["rays"]


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


def _eager(name: str, fn, state: dict) -> None:
    """Run the segment ``fn`` on ``state`` now, launch by launch."""
    profiling.count("wavefront.eager_segments")
    fn(state)


def _written(before: dict, after: dict) -> dict:
    """The keys a segment put new tensors under, with those tensors."""
    return {k: v for k, v in after.items() if before.get(k) is not v}


class _CudaCapture:
    """Captures a function's launches into a CUDA graph on ``device``;
    the graphs of one ``_Graphs`` share a memory pool (each copies what
    it keeps into buffers outside it, and they run one at a time)."""

    def __init__(self, device):
        self.device = device
        self.pool = None

    def __call__(self, body):
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), \
                torch.cuda.graph(graph, pool=self.pool):
            body()
        return graph


class _Graphs:
    """The wavefront's segments as CUDA graphs, for one scene, ray count
    and config.

    A segment reads tensors of a state dict and puts new tensors under
    some of its keys, with no host wait inside. The first run of a
    segment name is eager: it warms the segment up (the kernel library,
    the walk kernel's shared-memory attribute and launch shape, tables
    the scene packs at first use) and does this frame's work. Its new
    values are copied into fixed home buffers, one a key of the name's
    space (the part before the dot), and the segment is captured reading
    the tensors of the state it was given and copying its results into
    the homes. Later runs check that the state holds those same tensors
    and replay the capture. A capture launches nothing, so what it added
    to the tracer's counts (kernel launches, sweeps) is taken back and
    added again at each replay. A frame's rays and seeds are copied into
    the homes of the keys they start (``input``). ``capture(body)``
    returns an object whose ``replay()`` runs what ``body`` launched
    (``_CudaCapture``)."""

    def __init__(self, scene, key, capture):
        self.scene = weakref.ref(scene)
        self.key = key
        self.capture = capture
        self.graphs = {}    # name -> (graph, reads, writes, counts)
        self.homes = {}     # (space, key) -> tensor

    def input(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """``x`` copied into the home of ``name`` ("space.key"), which the
        graphs read and the segments that write the key rewrite."""
        key = tuple(name.split(".", 1))
        home = self.homes.get(key)
        if home is None:
            home = self.homes[key] = x.clone()
        else:
            home.copy_(x)
        return home

    def run(self, name: str, fn, state: dict) -> None:
        entry = self.graphs.get(name)
        if entry is not None:
            graph, reads, writes, counts = entry
            if any(state.get(k) is not v for k, v in reads.items()):
                raise RuntimeError(f"wavefront graph {name!r}: the state "
                                   "holds other tensors than at its capture")
            graph.replay()
            profiling.add_totals(counts)
            profiling.count("wavefront.graph_replays")
            state.update(writes)
            return
        space = name.partition(".")[0]
        reads = dict(state)
        _eager(name, fn, state)
        writes = {}
        for k, v in _written(reads, state).items():
            home = self.homes.get((space, k))
            if home is None:
                home = self.homes[(space, k)] = v.clone()
            else:
                home.copy_(v)
            writes[k] = home
        state.update(writes)

        def body():
            cap = dict(reads)
            fn(cap)
            got = _written(reads, cap)
            if got.keys() != writes.keys():
                raise RuntimeError(f"wavefront graph {name!r}: the capture "
                                   "wrote other keys than the eager run")
            for k, v in got.items():
                writes[k].copy_(v)

        before = profiling.totals()
        graph = self.capture(body)
        counts = {k: n - before.get(k, 0)
                  for k, n in profiling.totals().items()
                  if n != before.get(k, 0)}
        profiling.add_totals(counts, -1)
        profiling.count("wavefront.graph_captures")
        self.graphs[name] = (graph, reads, writes, counts)


# The one entry of the graph cache: the ``_Graphs`` of the last call that
# could take them. A program traces from one thread.
_GRAPHS = None


def _graphs_for(scene, P: int, cfg: RenderConfig, dev, impl):
    """The graphs a call replays, or None to run it eagerly. They need the
    kernels on a card, a width that stays P every round (no cluster mesh,
    so no compaction) and the same scene object, width and config as the
    previous call; any other call drops them."""
    global _GRAPHS
    if not (WAVEFRONT_GRAPHS and dev.type == "cuda" and impl == "kernel"
            and scene.mesh_clusters is None):
        _GRAPHS = None
        return None
    key = (P, cfg, stack_slots(cfg), dev)
    g = _GRAPHS
    if g is not None and g.scene() is scene and g.key == key:
        return g
    _GRAPHS = _Graphs(scene, key, _CudaCapture(dev))
    return None


def trace_all(scene, o0, d0, rng0, cfg: RenderConfig,
              impl=None) -> TraceResult:
    """Trace every pixel's full path tree. o0/d0: (P, 3); rng0: (P,) int64
    SplitMix64 states. ``impl`` picks the cluster-mesh sweep.

    A frame runs as segments with no host wait inside: ``wave.start``,
    then a round's ``wave.head0`` (round 0) or ``wave.head`` (the
    intersection up to the shadow rays' inputs), the shadow loop's
    segments (``transmittance_to_lights``) and ``wave.tail`` (direct
    light, bounce, pop and the next ``active`` mask); the checks for
    active lanes stay on the host between them. Where ``_graphs_for``
    allows, the segments replay from CUDA graphs (``WAVEFRONT_GRAPHS``),
    bit for bit the eager frame."""
    impl = resolve_impl(impl, o0.device)
    graphs = _graphs_for(scene, o0.shape[0], cfg, o0.device, impl)
    return _trace(scene, o0, d0, rng0, cfg, impl, graphs)


def _trace(scene, o0, d0, rng0, cfg: RenderConfig, impl,
           graphs) -> TraceResult:
    """``trace_all``'s frame, its segments run by ``graphs.run`` (None:
    eagerly)."""
    P = o0.shape[0]
    dev = o0.device
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

    lt = scene.lights
    L = lt.mask.shape[0]
    # Light-major shadow lanes: each 256-lane tile of the mesh sweep is
    # then consecutive rays toward one light, swept unsorted.
    lmaj = cfg.lmajor_shadow and L > 1 and mesh
    # Round 0 on every lane; with compaction, every later round on the
    # lanes still active (gathered once per round, in lane order, so tiles
    # stay coherent). Per-lane arithmetic does not depend on the other
    # lanes, so the result equals the uncompacted loop.
    compact = WAVEFRONT_COMPACTION and mesh
    run = _eager if graphs is None else graphs.run

    def start(st: dict) -> None:
        """A frame's lanes before round 0, beside its rays and seeds."""
        st.update(beta=torch.ones((P, 3), device=dev), mirror=i1(),
                  diffuse=i1(), active=b1(True), radiance=f3(),
                  lane_rays=i1(), is_primary=b1(True),
                  primary_hit=b1(False), is_sky=b1(False),
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
        st["active_any"] = st["active"].any()

    def head(st: dict, lod_sweep: bool) -> None:
        """A round's intersection, sky, emission, G-buffer, pushes and
        ambient light on the lanes of ``st``, in place, up to the shadow
        rays' inputs (``shadow_*``). ``lod_sweep``: a round after round 0
        (the LOD set; bounce populations binned)."""
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
            slot = torch.arange(S, device=dev)[:, None]
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

        # ---- diffuse: ambient, then the shadow rays' inputs ---------------
        amb_rgb = scene.ambient_color * scene.ambient_intensity
        st["radiance"] = st["radiance"] + torch.where(
            is_diffuse[:, None], beta * (amb_rgb * base_albedo), 0.0)
        st.update(p=p, n=n, albedo=base_albedo, can_bounce=can_bounce,
                  is_mirror=is_mirror, is_diffuse=is_diffuse)
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
            if lmaj:
                rows = lambda x, *c: x.transpose(0, 1).reshape(L * W, *c)
            else:
                rows = lambda x, *c: x.reshape(W * L, *c)
            st.update(need=need, ldir=ldir, dist2=dist2, ndotl=ndotl,
                      shadow_o=rows(so, 3), shadow_d=rows(ldir, 3),
                      shadow_max=rows(smax), shadow_need=rows(need))

    def tail(st: dict) -> None:
        """A round's direct light from the shadow loop's transmittance
        (``shadow_trans``, ``shadow_rays``), bounce, and continue or pop,
        on the lanes of ``st``, in place; then the next ``active`` mask."""
        o, d, beta, active = st["o"], st["d"], st["beta"], st["active"]
        mirror, diffuse = st["mirror"], st["diffuse"]
        p, n, base_albedo = st["p"], st["n"], st["albedo"]
        is_mirror, is_diffuse = st["is_mirror"], st["is_diffuse"]
        W = o.shape[0]
        wo = -d
        if L > 0:
            trans, shadow_rays = st["shadow_trans"], st["shadow_rays"]
            if lmaj:
                trans = trans.reshape(L, W, 3).transpose(0, 1)
                shadow_rays = shadow_rays.reshape(L, W).T
            else:
                trans = trans.reshape(W, L, 3)
                shadow_rays = shadow_rays.reshape(W, L)
            st["lane_rays"] = st["lane_rays"] + shadow_rays.sum(
                1, dtype=torch.int32)
            atten = lt.intensity[None] / st["dist2"]
            f_on = oren_nayar(base_albedo[:, None, :], n[:, None, :],
                              wo[:, None, :], st["ldir"], sigma_rad)
            contrib = (f_on * st["ndotl"][..., None] * lt.color[None]
                       * atten[..., None] * trans)
            contrib = torch.where(st["need"][..., None], contrib, 0.0)
            st["radiance"] = st["radiance"] + beta * contrib.sum(1)

        want_bounce = is_diffuse & (diffuse < cfg.diffuse_bounces)
        new_rng, bounce_dir = sampler.cosine_sample_hemisphere(n, st["rng"])
        st["rng"] = torch.where(want_bounce, new_rng, st["rng"])
        f_bounce = oren_nayar(base_albedo, n, wo, bounce_dir, sigma_rad)
        bounce_beta = beta * f_bounce * math.pi

        # ---- continue in place vs pop -------------------------------------
        mirror_cont = is_mirror & st["can_bounce"]
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
        if not compact:
            st["active_any"] = active.any()

    if graphs is not None:
        o0, d0, rng0 = (graphs.input(k, x) for k, x in
                        (("wave.o", o0), ("wave.d", d0), ("wave.rng", rng0)))
    st = dict(o=o0, d=d0, rng=rng0)
    run("wave.start", start, st)
    cur, lanes = st, None
    for rnd in range(cfg.max_trace_rounds):
        if compact and rnd > 0:
            cur, lanes = _compact(st, cur, lanes)
            if lanes.numel() == 0:
                break
        elif not profiling.sync("trace.round_live", bool,
                                cur["active_any"]):
            break
        run("wave.head" if rnd else "wave.head0",
            functools.partial(head, lod_sweep=rnd > 0), cur)
        if L > 0:
            # The span wraps the call, not the loop's body: a profiler
            # range opened inside a range that a tool wraps around
            # transmittance_to_lights would take its kernels from it.
            with profiling.span("wavefront.shadow"):
                cur["shadow_trans"], cur["shadow_rays"] = \
                    transmittance_to_lights(
                        scene, cur["shadow_o"], cur["shadow_d"],
                        cur["shadow_max"], cur["shadow_need"], cfg,
                        lod=use_lod, presort=False if lmaj else None,
                        impl=impl, graphs=graphs)
        run("wave.tail", tail, cur)
    if lanes is not None:
        _write_back(st, cur, lanes)

    out = {k: st[k] for k in ("radiance", "is_sky", "g_albedo", "g_normal",
                              "g_depth", "lane_rays")}
    if graphs is not None:   # the next frame's replays rewrite the homes
        out = {k: v.clone() for k, v in out.items()}
    return TraceResult(radiance=out["radiance"], is_sky=out["is_sky"],
                       albedo=out["g_albedo"], normal=out["g_normal"],
                       depth=out["g_depth"],
                       rays_traced=out["lane_rays"].sum(dtype=torch.int64),
                       lane_rays=out["lane_rays"])
