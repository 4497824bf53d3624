"""The two large composite scenes and the dynamic showcase scenes.

Port of ``yetanotherconsolegameengine_tpu/scene/showcase_scenes.py``, in
numpy and torch:

- ``build_museum``: a checker hall with three Cornell-style rooms, a mesh
  gallery on pedestals (three small meshes in one 2,636-triangle LBVH)
  and glass.
- ``build_exhibit_ring``: a seeded radial ring of themed vignettes around
  a central refractive hero mesh, with the C# original's dynamic entities
  (bobbing sphere, orbiting and pulsing lights) patching the sphere and
  light tables per frame (scene/entities.py).
- ``build_spinning_mesh``: a 3,840-triangle torus knot spinning about Y,
  its LBVH rebuilt on its device every frame.

The dynamic builders return a ``DynamicScene`` on the CPU; move it with
``DynamicScene.to(device)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .entities import (BobbingSphereEntity, DynamicScene,
                       OrbitingLightEntity, PulsingLightEntity,
                       SpinningMeshEntity)
from .materials import Material
from .mesh_loader import (find_asset, load_obj, make_gem, make_icosphere,
                          make_knot, make_torus, transform_mesh)
from .mesh_scenes import SWATCH, _auto_ground
from .tables import SceneBuilder, SceneData


def build_museum() -> SceneData:
    """The museum hall."""
    s = SceneBuilder("museum")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.05
    white = Material.solid((0.85, 0.85, 0.85))
    s.add_xz_rect(-14.0, 14.0, -20.0, 4.0, 0.0,
                  Material.checker((0.85, 0.85, 0.85), (0.25, 0.25, 0.25),
                                   1.0, specular=0.05))
    # Three Cornell-style rooms along the back, an exhibit in each.
    room_colors = [((0.8, 0.1, 0.1), (0.1, 0.8, 0.1)),
                   ((0.1, 0.3, 0.8), (0.8, 0.7, 0.1)),
                   ((0.7, 0.2, 0.7), (0.2, 0.7, 0.7))]
    for i, (left_c, right_c) in enumerate(room_colors):
        cx = -9.0 + i * 9.0
        x0, x1 = cx - 3.0, cx + 3.0
        z0, z1 = -19.0, -13.0
        s.add_yz_rect(0.0, 5.0, z0, z1, x0, Material.solid(left_c))
        s.add_yz_rect(0.0, 5.0, z0, z1, x1, Material.solid(right_c))
        s.add_xy_rect(x0, x1, 0.0, 5.0, z0, white)
        s.add_xz_rect(x0, x1, z0, z1, 5.0, white)
        s.add_xz_rect(cx - 0.8, cx + 0.8, -16.8, -15.2, 4.99,
                      Material.emissive((1.2, 1.2, 1.2)))
        s.add_light((cx, 4.5, -16.0), (1, 1, 1), 25.0)
        if i == 0:
            s.add_sphere((cx, 1.0, -16.0), 1.0,
                         Material.solid((0.95, 0.95, 0.95), reflectivity=0.92))
        elif i == 1:
            s.add_box((cx - 0.7, 0.0, -16.7), (cx + 0.7, 1.4, -15.3),
                      SWATCH["copper"])
        else:
            s.add_sphere((cx, 1.0, -16.0), 1.0, Material.glass())

    # Mesh gallery on pedestals along the hall.
    pedestal = Material.solid((0.6, 0.6, 0.65), specular=0.1)
    gallery = [("stanford-bunny.obj", lambda: make_icosphere(2),
                SWATCH["ivory"]),
               ("teapot.obj", lambda: make_torus(), SWATCH["jade"]),
               ("cow.obj", lambda: make_gem(), SWATCH["gold"])]
    for i, (asset, fb, mat) in enumerate(gallery):
        cx = -8.0 + i * 8.0
        s.add_cylinder((cx, 0.0, -8.0), 1.0, 0.0, 1.0, True, pedestal)
        path = find_asset(asset)
        if path is not None:
            tris = load_obj(path, scale=1.6, translate=(cx, 0.0, -8.0))
        else:
            tris = transform_mesh(fb(), scale=1.6, translate=(cx, 0.0, -8.0))
        s.add_mesh_triangles(_auto_ground(tris, 1.0), mat)

    # Glass centerpiece and key lights.
    s.add_sphere((0.0, 1.5, -3.5), 1.0, Material.glass())
    s.add_light((0.0, 8.0, -6.0), (1.0, 0.97, 0.9), 220.0)
    s.add_light((-8.0, 6.0, -2.0), (0.9, 0.93, 1.0), 90.0)
    s.bg_top = (0.5, 0.7, 1.0)
    s.bg_bottom = (0.92, 0.95, 1.0)
    s.set_camera((0.0, 2.2, 3.0), pitch=-0.08, fov=65.0)
    return s.build()


def _hsv(h, sv, v):
    i = int(h * 6.0) % 6
    f = h * 6.0 - int(h * 6.0)
    p = v * (1 - sv)
    q = v * (1 - f * sv)
    t = v * (1 - (1 - f) * sv)
    return [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
            (v, p, q)][i]


def build_exhibit_ring(seed: int = 1337) -> DynamicScene:
    """Seeded 'exhibit ring' with dynamic entities (TestScenesRandom.Build).

    Returns a DynamicScene: per-frame entity updates patch the light and
    sphere tables (no rebuilds; it renders through the wavefront)."""
    rng = np.random.RandomState(seed)
    s = SceneBuilder("exhibit_ring")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.03
    s.add_plane((0, 0, 0), (0, 1, 0),
                Material.checker((0.75, 0.75, 0.78), (0.18, 0.18, 0.2), 0.8))

    # Central refractive hero (the dragon slot; gem stand-in / real OBJ).
    path = find_asset("xyzrgb_dragon.obj")
    if path is not None:
        tris = load_obj(path, scale=2.4, translate=(0.0, 0.0, 0.0))
    else:
        tris = transform_mesh(make_gem(sides=8), scale=2.0,
                              translate=(0.0, 0.0, 0.0))
    s.add_mesh_triangles(_auto_ground(tris), Material.glass(ior=1.45))

    # Bobbing sphere vignette: reserve sphere index 0.
    bob_base = (3.5, 1.0, 0.0)
    s.add_sphere(bob_base, 0.6,
                 Material.solid((0.9, 0.4, 0.2), specular=0.3))

    # 12 themed vignettes on the ring (TestScenesRandom.cs:120-700).
    R = 7.0
    for k in range(12):
        # Half-step offset so no vignette sits on the camera axis and the
        # central hero stays visible (TestScenesRandom centers the dragon).
        ang = (k + 0.5) * 2.0 * math.pi / 12.0
        cx, cz = R * math.cos(ang), R * math.sin(ang)
        theme = k % 6
        rgb = _hsv(rng.rand(), 0.6 + 0.4 * rng.rand(), 0.6 + 0.4 * rng.rand())
        if theme == 0:
            refl = float(rng.rand() < 0.3) * 0.6
            s.add_sphere((cx, 0.7, cz), 0.7,
                         Material.solid(rgb, specular=0.3, reflectivity=refl))
        elif theme == 1:
            s.add_box((cx - 0.5, 0.0, cz - 0.5), (cx + 0.5, 1.2, cz + 0.5),
                      Material.solid(rgb, specular=0.2))
        elif theme == 2:
            s.add_cylinder((cx, 0.0, cz), 0.5, 0.0, 1.4, True,
                           Material.solid(rgb, specular=0.25))
        elif theme == 3:
            s.add_sphere((cx, 0.8, cz), 0.8, Material.glass(
                transmission=tuple(min(1.0, c + 0.4) for c in rgb)))
        elif theme == 4:
            s.add_sphere((cx, 0.6, cz), 0.6,
                         Material.solid((0.95, 0.95, 0.95), reflectivity=0.92))
        else:
            s.add_sphere((cx, 1.8, cz), 0.35,
                         Material.emissive(tuple(3.0 * c for c in rgb)))

    # Lights: key (pulsing, index 0), orbiter (index 1), fill.
    s.add_light((0.0, 9.0, 4.0), (1.0, 0.96, 0.9), 240.0)
    s.add_light((4.0, 3.0, 0.0), (0.9, 0.6, 1.0), 60.0)
    s.add_light((-6.0, 5.0, -6.0), (0.8, 0.9, 1.0), 80.0)
    s.bg_top = (0.45, 0.65, 0.95)
    s.bg_bottom = (0.9, 0.94, 1.0)
    s.set_camera((0.0, 2.6, 11.0), pitch=-0.15, fov=62.0)

    base = s.build()
    entities = [
        BobbingSphereEntity(index=0, base_center=bob_base, amplitude=0.5,
                            freq_hz=0.4),
        OrbitingLightEntity(index=1, pivot=(0.0, 0.0, 0.0), radius=4.5,
                            height=3.0, period_s=7.0),
        PulsingLightEntity(index=0, base_intensity=240.0, depth=0.35,
                           freq_hz=0.6),
    ]
    return DynamicScene(base, entities)


def build_spinning_mesh() -> DynamicScene:
    """Dynamic-mesh scene: a torus knot spinning about Y whose LBVH is
    rebuilt on its device every frame (scene/entities.SpinningMeshEntity
    -> ops/lbvh.build_lbvh), the C# original's Scene.RebuildBVH over
    changed geometry (Scenes/Scene.cs:66-69, 122-127)."""
    s = SceneBuilder("spinning_mesh")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.05
    s.add_xz_rect(-10.0, 10.0, -10.0, 5.0, 0.0,
                  Material.checker((0.8, 0.8, 0.85), (0.18, 0.18, 0.2),
                                   0.8, specular=0.05))
    s.add_light((3.0, 5.0, 2.5), (1.0, 0.96, 0.9), 110.0)
    s.bg_top = (0.5, 0.7, 1.0)
    s.bg_bottom = (0.92, 0.96, 1.0)
    tris = transform_mesh(make_knot(), normalize=True, scale=1.9,
                          translate=(0.0, 0.0, -3.2))
    tris = _auto_ground(tris, floor_y=0.35)
    s.add_mesh_triangles(tris, SWATCH["copper"])
    mid = s._mesh_tris[-1][1]
    s.set_camera((0.0, 1.8, 1.2), pitch=-0.12, fov=60.0)
    base = s.build()

    cx, cz = float(tris[:, :, 0].mean()), float(tris[:, :, 2].mean())
    T = tris.shape[0]
    vert = lambda k: torch.from_numpy(np.ascontiguousarray(tris[:, k],
                                                           np.float32))
    ent = SpinningMeshEntity(
        a0=vert(0), b0=vert(1), c0=vert(2),
        mat=torch.full((T,), mid, dtype=torch.int32),
        pivot=(cx, 0.0, cz), spin_hz=0.12)
    return DynamicScene(base, [ent])


SHOWCASE_SCENE_BUILDERS = {
    "museum": build_museum,
    "exhibit_ring": build_exhibit_ring,
    "spinning_mesh": build_spinning_mesh,
}
