"""Scene inputs: materials, primitive tables, lights and a triangle soup.

``SceneBuilder`` collects a scene the way the C# scene table's builders
add it (rectangles, boxes, spheres, capped Y cylinders, lights, bulk mesh
triangles), dedupes materials into a bank in insertion order (id 0 is a
neutral grey default), and ``build`` returns the scene as flat numpy
arrays (``SceneInputs``): the inputs the benchmark holds the program's
scene to. A mesh of at least ``lod.CLUSTER_MIN_TRIS`` triangles is a
cluster mesh: beside it ``build`` derives its proxy sets by the program's
published rules (``lod.py``). ``Scene.from_inputs`` turns the inputs into
torch tables on a device, in a float dtype, for ``trace.py``.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Dict, Tuple

import numpy as np
import torch

from . import lod

PROC_SOLID = 0
PROC_CHECKER = 1
PROC_CELL_TINT = 3   # 2 is a texture, which no scene here has

# Columns of each primitive table, with their dtype and width (0: scalar).
TABLES = {
    "spheres": (("center", np.float32, 3), ("radius", np.float32, 0),
                ("mat", np.int32, 0)),
    "boxes": (("bmin", np.float32, 3), ("bmax", np.float32, 3),
              ("mat", np.int32, 0)),
    "rects": (("axis", np.int32, 0), ("k", np.float32, 0),
              ("u0", np.float32, 0), ("u1", np.float32, 0),
              ("v0", np.float32, 0), ("v1", np.float32, 0),
              ("mat", np.int32, 0)),
    "cylinders": (("cx", np.float32, 0), ("cz", np.float32, 0),
                  ("radius", np.float32, 0), ("ymin", np.float32, 0),
                  ("ymax", np.float32, 0), ("capped", np.bool_, 0),
                  ("mat", np.int32, 0)),
    "disks": (("center", np.float32, 3), ("normal", np.float32, 3),
              ("radius", np.float32, 0), ("mat", np.int32, 0)),
    "planes": (("normal", np.float32, 3), ("d", np.float32, 0),
               ("mat", np.int32, 0)),
    "triangles": (("a", np.float32, 3), ("e1", np.float32, 3),
                  ("e2", np.float32, 3), ("n", np.float32, 3),
                  ("mat", np.int32, 0)),
    "lights": (("pos", np.float32, 3), ("color", np.float32, 3),
               ("intensity", np.float32, 0)),
}
# Material columns; every one is float32 but ``proc`` and ``tex_id``.
MATERIAL_FIELDS = ("albedo", "specular", "reflectivity", "emission",
                   "transparency", "ior", "transmission", "proc", "albedo2",
                   "proc_scale", "tex_id", "tex_weight", "uv_scale")
VECTORS = ("ambient_color", "ambient_intensity", "bg_top", "bg_bottom")


@dataclasses.dataclass(frozen=True)
class Material:
    albedo: Tuple[float, float, float] = (0.7, 0.7, 0.7)
    specular: float = 0.0
    reflectivity: float = 0.0
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    transparency: float = 0.0
    ior: float = 1.5
    transmission: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    proc: int = PROC_SOLID
    albedo2: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    proc_scale: float = 1.0
    tex_id: int = -1
    tex_weight: float = 1.0
    uv_scale: float = 1.0

    @staticmethod
    def solid(albedo, specular=0.0, reflectivity=0.0):
        return Material(albedo=tuple(albedo), specular=specular,
                        reflectivity=reflectivity)

    @staticmethod
    def emissive(emission):
        return Material(albedo=(0.0, 0.0, 0.0), emission=tuple(emission))

    @staticmethod
    def checker(a, b, scale, specular=0.0):
        return Material(albedo=tuple(a), albedo2=tuple(b), proc=PROC_CHECKER,
                        proc_scale=scale, specular=specular)

    @staticmethod
    def glass(reflectivity=0.02, ior=1.5):
        return Material(albedo=(1.0, 1.0, 1.0), reflectivity=reflectivity,
                        transparency=1.0, ior=ior)


# Key: {"<table>.<column>": array} of the valid rows, the material bank
# ("materials.<field>"), the sky and ambient vectors, "defaults" (px, py,
# pz, yaw, pitch, fov) and the mesh soup ("mesh.a", "mesh.b", "mesh.c",
# "mesh.mat"), when the scene has one. A cluster mesh adds "mesh.kc" (its
# triangles a cluster) and "mesh.t_bias", and each of its proxy sets
# ("mesh_fine", "mesh_lod", "mesh_shadow", as ``lod.proxy_sets`` builds
# them) the same six keys under its own name.
SceneInputs = Dict[str, np.ndarray]


class SceneBuilder:
    def __init__(self, name: str):
        self.name = name
        self._mats = [Material()]
        self._ids = {Material(): 0}
        self._rows = {t: [] for t in TABLES}
        self._mesh = []
        self._cluster_budgets = None
        self.ambient_color = (1.0, 1.0, 1.0)
        self.ambient_intensity = 0.075
        self.bg_top = (0.6, 0.8, 1.0)
        self.bg_bottom = (1.0, 1.0, 1.0)
        self.defaults = (0.0, 1.0, 0.0, 0.0, 0.0, 60.0)

    def mat(self, m: Material) -> int:
        if m not in self._ids:
            self._ids[m] = len(self._mats)
            self._mats.append(m)
        return self._ids[m]

    def rect(self, axis, k, u0, u1, v0, v1, m):
        self._rows["rects"].append((axis, k, u0, u1, v0, v1, self.mat(m)))

    def xy_rect(self, x0, x1, y0, y1, z, m):
        self.rect(2, z, x0, x1, y0, y1, m)

    def xz_rect(self, x0, x1, z0, z1, y, m):
        self.rect(1, y, x0, x1, z0, z1, m)

    def yz_rect(self, y0, y1, z0, z1, x, m):
        self.rect(0, x, y0, y1, z0, z1, m)

    def box(self, bmin, bmax, m):
        self._rows["boxes"].append((bmin, bmax, self.mat(m)))

    def sphere(self, center, radius, m):
        self._rows["spheres"].append((center, radius, self.mat(m)))

    def cylinder(self, center, radius, y0, y1, capped, m):
        self._rows["cylinders"].append((center[0], center[2], radius,
                                        min(y0, y1), max(y0, y1), capped,
                                        self.mat(m)))

    def light(self, pos, color, intensity):
        self._rows["lights"].append((pos, color, intensity))

    def mesh(self, tris, m):
        self._mesh.append((np.asarray(tris, np.float32), self.mat(m)))

    def force_clusters(self, budgets: dict):
        """Make the mesh a cluster mesh whatever its size, with the proxy
        sets of ``budgets`` ({"fine", "lod", "shadow"} triangles; empty:
        none), as the program's small test scenes force it."""
        self._cluster_budgets = dict(budgets)

    def camera(self, pos, yaw=0.0, pitch=0.0, fov=60.0):
        self.defaults = (*(float(v) for v in pos), float(yaw), float(pitch),
                         float(fov))

    def build(self) -> SceneInputs:
        out = {}
        for t, cols in TABLES.items():
            rows = self._rows[t]
            for i, (name, dtype, width) in enumerate(cols):
                shape = (len(rows), width) if width else (len(rows),)
                out[f"{t}.{name}"] = np.asarray(
                    [r[i] for r in rows], dtype).reshape(shape)
        for f in MATERIAL_FIELDS:
            dtype = np.int32 if f in ("proc", "tex_id") else np.float32
            out[f"materials.{f}"] = np.asarray(
                [getattr(m, f) for m in self._mats], dtype)
        for v in VECTORS:
            out[v] = np.asarray(getattr(self, v), np.float32)
        out["defaults"] = np.asarray(self.defaults, np.float64)
        if self._mesh:
            tris = np.concatenate([t for t, _ in self._mesh])
            mats = np.concatenate(
                [np.full(t.shape[0], m, np.int32) for t, m in self._mesh])
            sets = {"mesh": (tris, mats, 0.0)}
            forced = self._cluster_budgets
            clusters = (forced is not None
                        or tris.shape[0] >= lod.CLUSTER_MIN_TRIS)
            if clusters and forced != {}:
                sets.update(lod.proxy_sets(tris, mats, forced))
            for name, (t, m, bias) in sets.items():
                out[f"{name}.a"], out[f"{name}.b"], out[f"{name}.c"] = (
                    np.ascontiguousarray(t[:, i]) for i in range(3))
                out[f"{name}.mat"] = m
                if clusters:
                    out[f"{name}.kc"] = np.asarray(
                        lod.KC if name == "mesh" else lod.PROXY_KC, np.int32)
                    out[f"{name}.t_bias"] = np.asarray(bias, np.float64)
        return out


# -- procedural meshes --------------------------------------------------------

def transform_mesh(tris, scale: float, translate) -> np.ndarray:
    """Fit the mesh's largest extent to 1 about its box centre, then scale
    and translate."""
    tris = np.asarray(tris, np.float32)
    lo = tris.reshape(-1, 3).min(axis=0)
    hi = tris.reshape(-1, 3).max(axis=0)
    tris = (tris - (lo + hi) * 0.5) / max(float((hi - lo).max()), 1e-12)
    return tris * np.float32(scale) + np.asarray(translate, np.float32)


def on_floor(tris: np.ndarray, floor_y: float) -> np.ndarray:
    lo = np.asarray(tris, np.float32).reshape(-1, 3).min(axis=0)
    return tris + np.asarray([0.0, floor_y - lo[1], 0.0], np.float32)


def icosphere(subdivisions: int) -> np.ndarray:
    """Unit icosphere, 20 * 4^s triangles."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.asarray([(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
                    (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
                    (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)],
                   np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    tris = v[np.asarray(f)]
    for _ in range(subdivisions):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        for m in (ab, bc, ca):
            m /= np.linalg.norm(m, axis=1, keepdims=True)
        tris = np.concatenate([np.stack([a, ab, ca], 1),
                               np.stack([ab, b, bc], 1),
                               np.stack([ca, bc, c], 1),
                               np.stack([ab, bc, ca], 1)])
    return tris.astype(np.float32)


def torus(major=1.0, minor=0.35, seg_u=48, seg_v=24) -> np.ndarray:
    """Torus in the XZ plane, two triangles a quad."""
    u = np.linspace(0, 2 * np.pi, seg_u, endpoint=False)
    v = np.linspace(0, 2 * np.pi, seg_v, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    p = np.stack([(major + minor * np.cos(vv)) * np.cos(uu),
                  minor * np.sin(vv),
                  (major + minor * np.cos(vv)) * np.sin(uu)], axis=-1)
    i1 = (np.arange(seg_u) + 1) % seg_u
    j1 = (np.arange(seg_v) + 1) % seg_v
    p00, p10 = p, p[i1]
    p01, p11 = p[:, j1], p[i1][:, j1]
    t1 = np.stack([p00, p10, p11], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([p00, p11, p01], axis=2).reshape(-1, 3, 3)
    return np.concatenate([t1, t2]).astype(np.float32)


def gem(sides=6, height=1.0, radius=0.6) -> np.ndarray:
    """A faceted bipyramid."""
    a = np.linspace(0, 2 * np.pi, sides, endpoint=False)
    ring = np.stack([radius * np.cos(a), np.zeros(sides),
                     radius * np.sin(a)], axis=-1)
    top, bot = np.asarray([0.0, height * 0.5, 0.0]), \
        np.asarray([0.0, -height * 0.5, 0.0])
    tris = []
    for i in range(sides):
        j = (i + 1) % sides
        tris += [(top, ring[i], ring[j]), (bot, ring[j], ring[i])]
    return np.asarray(tris, np.float32)


# -- torch tables ---------------------------------------------------------------

def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _morton(n01: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes of points in [0, 1]^3."""
    def spread(v):
        v = (torch.clamp(v, 0.0, 1.0) * 1023.0).to(torch.int64) & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249
    return (spread(n01[:, 0]) << 2) | (spread(n01[:, 1]) << 1) \
        | spread(n01[:, 2])


GROUP = 64   # triangles a spatial group of a mesh object


class Scene(SimpleNamespace):
    """Torch tables of a scene: ``spheres``, ``boxes``, ... and ``lights``
    (namespaces of columns), ``materials``, the sky and ambient vectors,
    ``defaults`` and, for a scene with a mesh, ``mesh`` (a, e1, e2, n, mat
    in Morton order of the triangles' box centres, ties in input order,
    ``kc`` and ``t_bias``; see ``_mesh_table``), and for a cluster mesh
    ``mesh_fine``, ``mesh_lod`` and ``mesh_shadow`` alike where it has
    them (else None)."""

    @staticmethod
    def from_inputs(d: SceneInputs, device, dtype=torch.float32) -> "Scene":
        def t(a):
            a = torch.from_numpy(np.ascontiguousarray(a)).to(device)
            return a.to(dtype) if a.is_floating_point() else a
        s = Scene(defaults=tuple(float(v) for v in d["defaults"]))
        for tab, cols in TABLES.items():
            setattr(s, tab, SimpleNamespace(
                **{c: t(d[f"{tab}.{c}"]) for c, _, _ in cols}))
        s.materials = SimpleNamespace(
            **{f: t(d[f"materials.{f}"]) for f in MATERIAL_FIELDS})
        for v in VECTORS:
            setattr(s, v, t(d[v]))
        s.any_transparent = bool((d["materials.transparency"] > 0).any())
        for name in lod.SETS:
            setattr(s, name, _mesh_table(d, name, device, dtype)
                    if f"{name}.a" in d else None)
        return s


def _mesh_table(d: SceneInputs, name: str, device, dtype):
    """The triangles of the set ``name`` in Morton order, with ``kc`` (its
    triangles a cluster; None for a mesh that is not a cluster mesh),
    ``t_bias`` (where its rays start at the least) and its ``objects``
    (``_mesh_groups``)."""
    # Derived in float32 from the input vertices, then cast.
    a, b, c = (torch.from_numpy(d[f"{name}.{k}"]).to(device) for k in "abc")
    lo3 = torch.minimum(torch.minimum(a, b), c)
    hi3 = torch.maximum(torch.maximum(a, b), c)
    cent = (lo3 + hi3) * 0.5
    lo = cent.amin(0)
    ext = torch.clamp(cent.amax(0) - lo, min=1e-12)
    order = torch.sort(_morton((cent - lo) / ext), stable=True).indices
    a, b, c = a[order], b[order], c[order]
    e1, e2 = b - a, c - a
    n = _cross(e1, e2)
    n = n / torch.sqrt(torch.clamp(_dot(n, n), min=1e-20))[:, None]
    kc = d.get(f"{name}.kc")
    m = SimpleNamespace(
        a=a.to(dtype), e1=e1.to(dtype), e2=e2.to(dtype), n=n.to(dtype),
        mat=torch.from_numpy(d[f"{name}.mat"]).to(device)[order],
        kc=None if kc is None else int(kc),
        t_bias=float(d.get(f"{name}.t_bias", 0.0)))
    m.objects = _mesh_groups(m, d[f"{name}.mat"], order, lo3[order],
                             hi3[order])
    return m


def _box(lo, hi):
    """A box padded by 1e-3 and a thousandth of its extent, kept in
    float32 whatever the dtype, so that a skip never drops a hit."""
    pad = 1e-3 + 1e-3 * (hi - lo).amax(-1, keepdim=True)
    return lo - pad, hi + pad


def _mesh_groups(mesh, mat, order, lo3, hi3):
    """One object a run of equal material in the input order, with its
    padded box, cut into spatial groups of ``GROUP`` consecutive
    triangles of ``mesh``'s order, each with its own padded box: ``idx``
    (G, GROUP) positions in ``mesh`` (ascending; padding slots hold 0),
    their ``a``, ``e1``, ``e2`` (G, GROUP, 3; zero in padding slots, so
    never hit) and ``lo``, ``hi`` (G, 3)."""
    mat = np.asarray(mat)
    cuts = [0, *(np.flatnonzero(mat[1:] != mat[:-1]) + 1).tolist(),
            mat.shape[0]]
    objects = []
    for s, e in zip(cuts, cuts[1:]):
        idx = torch.nonzero((order >= s) & (order < e))[:, 0]
        n = idx.shape[0]
        G = -(-n // GROUP)
        slot = torch.arange(G * GROUP, device=idx.device)
        real = (slot < n).reshape(G, GROUP)
        gidx = torch.where(slot < n, idx[slot.clamp(max=n - 1)], 0) \
            .reshape(G, GROUP)
        cols = {k: torch.where(real[..., None], getattr(mesh, k)[gidx], 0.0)
                for k in ("a", "e1", "e2")}
        far = torch.tensor(3.0e38, device=idx.device)
        glo, ghi = _box(torch.where(real[..., None], lo3[gidx], far).amin(1),
                        torch.where(real[..., None], hi3[gidx], -far)
                        .amax(1))
        olo, ohi = _box(lo3[idx].amin(0), hi3[idx].amax(0))
        objects.append(SimpleNamespace(lo=olo, hi=ohi, groups=SimpleNamespace(
            idx=gidx, lo=glo, hi=ghi, **cols)))
    return objects
