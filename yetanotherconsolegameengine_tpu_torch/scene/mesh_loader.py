"""OBJ mesh loading and procedural meshes (numpy only).

A copy of ``yetanotherconsolegameengine_tpu/scene/mesh_loader.py``, which
imports nothing but numpy: ``load_obj`` (``v``/``f`` records, fan
triangulation, negative indices, normalize + scale + translate),
``transform_mesh``, ``mesh_bounds`` and the procedural stand-ins
(icosphere, torus, knot, the ~600k-triangle ``make_dragon``, gem).
``find_asset`` looks in ``YACGE_ASSET_DIR`` and the checkout's ``assets/``
and returns None when the OBJ is absent; the mesh scenes then use the
procedural stand-ins. tests/test_torch_mesh_scene.py holds the outputs
equal to the JAX package's.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

_ASSET_DIRS = (
    os.environ.get("YACGE_ASSET_DIR", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "assets"),
)


def find_asset(name: str) -> Optional[str]:
    for d in _ASSET_DIRS:
        if not d:
            continue
        p = os.path.join(d, name)
        if os.path.isfile(p):
            return p
    return None


def load_obj(path: str, normalize: bool = True, scale: float = 1.0,
             translate: Sequence[float] = (0.0, 0.0, 0.0)) -> np.ndarray:
    """Parse an OBJ file -> (T, 3, 3) float32 triangle vertex array."""
    verts: list = []
    faces: list = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]),
                              float(parts[3])))
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    s = tok.split("/")[0]
                    if not s:
                        continue
                    i = int(s)
                    # Negative = relative to current vertex count
                    # (MeshLoader.cs:106-112).
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    tris = v[f]  # (T, 3, 3)
    return transform_mesh(tris, normalize, scale, translate)


def transform_mesh(tris: np.ndarray, normalize: bool = True,
                   scale: float = 1.0,
                   translate: Sequence[float] = (0.0, 0.0, 0.0)) -> np.ndarray:
    """Normalize-to-unit + scale + translate (MeshLoader.cs:40-76)."""
    tris = np.asarray(tris, np.float32)
    if normalize and tris.size:
        lo = tris.reshape(-1, 3).min(axis=0)
        hi = tris.reshape(-1, 3).max(axis=0)
        center = (lo + hi) * 0.5
        extent = float((hi - lo).max())
        tris = (tris - center) / max(extent, 1e-12)
    tris = tris * np.float32(scale) + np.asarray(translate, np.float32)
    return tris


def mesh_bounds(tris: np.ndarray):
    flat = np.asarray(tris, np.float32).reshape(-1, 3)
    return flat.min(axis=0), flat.max(axis=0)


# -- procedural stand-in meshes ----------------------------------------------

def make_icosphere(subdivisions: int = 3) -> np.ndarray:
    """Unit icosphere, (T, 3, 3). 20 * 4^s triangles."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.asarray([
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    tris = v[np.asarray(f)]
    for _ in range(subdivisions):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        for m in (ab, bc, ca):
            m /= np.linalg.norm(m, axis=1, keepdims=True)
        tris = np.concatenate([
            np.stack([a, ab, ca], 1), np.stack([ab, b, bc], 1),
            np.stack([ca, bc, c], 1), np.stack([ab, bc, ca], 1)])
    return tris.astype(np.float32)


def make_torus(major: float = 1.0, minor: float = 0.35,
               seg_u: int = 48, seg_v: int = 24) -> np.ndarray:
    """Torus in the XZ plane, (T, 3, 3)."""
    u = np.linspace(0, 2 * np.pi, seg_u, endpoint=False)
    v = np.linspace(0, 2 * np.pi, seg_v, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (major + minor * np.cos(vv)) * np.cos(uu)
    y = minor * np.sin(vv)
    z = (major + minor * np.cos(vv)) * np.sin(uu)
    p = np.stack([x, y, z], axis=-1)  # (U, V, 3)
    i = np.arange(seg_u)
    j = np.arange(seg_v)
    i1 = (i + 1) % seg_u
    j1 = (j + 1) % seg_v
    p00 = p[i][:, j]
    p10 = p[i1][:, j]
    p01 = p[i][:, j1]
    p11 = p[i1][:, j1]
    t1 = np.stack([p00, p10, p11], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([p00, p11, p01], axis=2).reshape(-1, 3, 3)
    return np.concatenate([t1, t2]).astype(np.float32)


def make_knot(p: int = 2, q: int = 3, seg_u: int = 160, seg_v: int = 12,
              tube: float = 0.16) -> np.ndarray:
    """(p, q) torus knot tube — a dense test mesh (~4k tris)."""
    u = np.linspace(0, 2 * np.pi, seg_u, endpoint=False)
    r = np.cos(q * u) + 2.0
    center = np.stack([r * np.cos(p * u), -np.sin(q * u),
                       r * np.sin(p * u)], axis=-1)
    # Frenet-ish frame from finite differences.
    tang = np.roll(center, -1, 0) - np.roll(center, 1, 0)
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    ref = np.asarray([0.0, 1.0, 0.0])
    side = np.cross(tang, ref)
    side /= np.maximum(np.linalg.norm(side, axis=1, keepdims=True), 1e-9)
    up = np.cross(side, tang)
    v = np.linspace(0, 2 * np.pi, seg_v, endpoint=False)
    circ = (np.cos(v)[None, :, None] * side[:, None, :]
            + np.sin(v)[None, :, None] * up[:, None, :])
    ring = center[:, None, :] + tube * circ  # (U, V, 3)
    i = np.arange(seg_u)
    j = np.arange(seg_v)
    i1 = (i + 1) % seg_u
    j1 = (j + 1) % seg_v
    p00 = ring[i][:, j]
    p10 = ring[i1][:, j]
    p01 = ring[i][:, j1]
    p11 = ring[i1][:, j1]
    t1 = np.stack([p00, p10, p11], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([p00, p11, p01], axis=2).reshape(-1, 3, 3)
    return np.concatenate([t1, t2]).astype(np.float32)


def make_dragon(seg_u: int = 1152, seg_v: int = 260) -> np.ndarray:
    """Dragon-class procedural hero mesh: ~2*seg_u*seg_v triangles
    (defaults: 599,040 — the same order as the reference's
    ``xyzrgb_dragon.obj``, a missing large blob in the mount, loaded by
    MeshScenes.cs:135-143). The BASELINE.md north star (60 fps @ 240x135 on
    a dragon-class mesh) needs a real ~half-million-triangle denominator,
    so this sweeps a coiling, tapered serpentine body with elliptical
    cross-sections, multi-frequency "scale" displacement and dorsal ridge
    spikes — compact spatial extent, high curvature, uneven triangle
    density: a deliberately BVH-hostile shape, unlike a smooth knot.
    Deterministic (pure trig), ~1 s to generate.
    """
    u = np.linspace(0.0, 1.0, seg_u, endpoint=False)
    # Coiling path: two horizontal loops that rise, then a rearing "neck".
    ang = u * (4.0 * np.pi)
    coil_r = 1.6 - 0.9 * u                       # spiral inward
    rise = 1.8 * u ** 1.5
    neck = np.clip((u - 0.82) / 0.18, 0.0, 1.0)  # head rears up
    center = np.stack([
        coil_r * np.cos(ang),
        rise + 1.2 * neck ** 2,
        coil_r * np.sin(ang),
    ], axis=-1)
    # Frame from finite differences.
    tang = np.roll(center, -1, 0) - np.roll(center, 1, 0)
    tang[0] = center[1] - center[0]
    tang[-1] = center[-1] - center[-2]
    tang /= np.maximum(np.linalg.norm(tang, axis=1, keepdims=True), 1e-9)
    ref = np.asarray([0.0, 1.0, 0.0])
    side = np.cross(tang, ref)
    side /= np.maximum(np.linalg.norm(side, axis=1, keepdims=True), 1e-9)
    up = np.cross(side, tang)

    # Tapered elliptical body: fat belly, thin tail, bulbous head.
    body = 0.32 * np.sin(np.pi * np.clip(u / 0.9, 0.0, 1.0)) ** 0.7 + 0.02
    head = 0.16 * np.exp(-((u - 0.97) / 0.035) ** 2)
    rad = body + head                              # (U,)

    v = np.linspace(0.0, 2.0 * np.pi, seg_v, endpoint=False)
    uu = u[:, None]
    vv = v[None, :]
    # Scale/ridge displacement: several incommensurate sine octaves plus
    # dorsal spikes along the back (v ~ pi/2).
    disp = (0.08 * np.sin(73.0 * uu * 2 * np.pi + 3.0 * vv)
            * np.sin(11.0 * vv + 41.0 * uu * 2 * np.pi)
            + 0.05 * np.sin(187.0 * uu * 2 * np.pi + 7.0 * vv)
            + 0.04 * np.cos(311.0 * uu * 2 * np.pi - 5.0 * vv))
    spike = (np.maximum(0.0, np.cos(vv - 0.5 * np.pi)) ** 24
             * (0.5 + 0.5 * np.sin(140.0 * uu * 2 * np.pi)) * 0.9)
    r_uv = rad[:, None] * (1.0 + disp + spike)     # (U, V)

    ell = 1.25  # taller than wide
    circ = (np.cos(vv)[..., None] * side[:, None, :]
            + ell * np.sin(vv)[..., None] * up[:, None, :])
    ring = center[:, None, :] + r_uv[..., None] * circ   # (U, V, 3)

    i = np.arange(seg_u - 1)   # open ends (tail tip / head cap via taper->0)
    j = np.arange(seg_v)
    i1 = i + 1
    j1 = (j + 1) % seg_v
    p00 = ring[i][:, j]
    p10 = ring[i1][:, j]
    p01 = ring[i][:, j1]
    p11 = ring[i1][:, j1]
    t1 = np.stack([p00, p10, p11], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([p00, p11, p01], axis=2).reshape(-1, 3, 3)
    return np.concatenate([t1, t2]).astype(np.float32)


def make_gem(sides: int = 6, height: float = 1.0,
             radius: float = 0.6) -> np.ndarray:
    """Low-poly bipyramid "gem" — a tiny faceted refraction test mesh."""
    a = np.linspace(0, 2 * np.pi, sides, endpoint=False)
    ring = np.stack([radius * np.cos(a), np.zeros(sides),
                     radius * np.sin(a)], axis=-1)
    top = np.asarray([0.0, height * 0.5, 0.0])
    bot = np.asarray([0.0, -height * 0.5, 0.0])
    tris = []
    for i in range(sides):
        j = (i + 1) % sides
        tris.append((top, ring[i], ring[j]))
        tris.append((bot, ring[j], ring[i]))
    return np.asarray(tris, np.float32)
