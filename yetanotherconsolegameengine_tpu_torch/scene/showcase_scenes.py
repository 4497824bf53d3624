"""The static showcase scene: the museum.

Port of ``build_museum`` of
``yetanotherconsolegameengine_tpu/scene/showcase_scenes.py``: a checker
hall with three Cornell-style rooms, a mesh gallery on pedestals (three
small meshes in one 2,636-triangle LBVH) and glass. The dynamic showcase
scenes (``exhibit_ring``, ``spinning_mesh``) need the entity system, which
is not ported (ROADMAP.md Queue 1 item 12).
"""

from __future__ import annotations

from .materials import Material
from .mesh_loader import (find_asset, load_obj, make_gem, make_icosphere,
                          make_torus, transform_mesh)
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


SHOWCASE_SCENE_BUILDERS = {"museum": build_museum}
