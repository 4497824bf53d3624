"""The dragon of the C# scene table (MeshScenes.cs:135-143, which loads
``xyzrgb_dragon.obj``) as the program builds it without the asset: the
procedural 598,520-triangle stand-in, fitted to 2.6 units about
(0, 0, -3.5) and set on a checker stage with two lights, seen from
(0, 1.6, 1.5). Its mesh is a cluster mesh, so ``build`` also derives the
fine, LOD and shadow proxy sets by the program's published rules."""

from __future__ import annotations

import numpy as np

from ..scene import Material, SceneBuilder, SceneInputs, on_floor, \
    transform_mesh


def make_dragon(seg_u: int = 1152, seg_v: int = 260) -> np.ndarray:
    """The procedural stand-in of the xyzrgb dragon: a coiling, tapered
    serpentine body with elliptical cross-sections, multi-frequency
    "scale" displacement and dorsal ridge spikes, 2 * (seg_u - 1) * seg_v
    triangles (598,520 by default). Pure trigonometry, deterministic."""
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


def build() -> SceneInputs:
    s = SceneBuilder("dragon")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.04
    s.xz_rect(-12.0, 12.0, -12.0, 6.0, 0.0,
              Material.checker((0.82, 0.82, 0.82), (0.2, 0.2, 0.2), 0.75,
                               specular=0.05))
    s.light((2.5, 5.0, 2.0), (1.0, 0.97, 0.9), 120.0)
    s.light((-3.0, 4.0, -1.0), (0.85, 0.9, 1.0), 60.0)
    s.bg_top = (0.55, 0.75, 1.0)
    s.bg_bottom = (0.95, 0.98, 1.0)
    tris = transform_mesh(make_dragon(), 2.6, (0.0, 0.0, -3.5))
    s.mesh(on_floor(tris, 0.0),
           Material.solid((0.95, 0.78, 0.25), specular=0.5,
                          reflectivity=0.35))
    s.camera((0.0, 1.6, 1.5), fov=60.0)
    return s.build()
