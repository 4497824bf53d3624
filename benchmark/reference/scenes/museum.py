"""The museum of the C# scene table: a checker hall with three
Cornell-style rooms along the back (a mirror sphere, a copper box and a
glass sphere), a mesh gallery on three capped pedestals (the procedural
stand-ins of the bunny, teapot and cow: an icosphere, a torus and a gem,
2,636 triangles), a glass centrepiece and five lights."""

from __future__ import annotations

from ..scene import (Material, SceneBuilder, SceneInputs, gem, icosphere,
                     on_floor, torus, transform_mesh)


def build() -> SceneInputs:
    s = SceneBuilder("museum")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.05
    white = Material.solid((0.85, 0.85, 0.85))
    s.xz_rect(-14.0, 14.0, -20.0, 4.0, 0.0,
              Material.checker((0.85, 0.85, 0.85), (0.25, 0.25, 0.25), 1.0,
                               specular=0.05))
    room_colors = [((0.8, 0.1, 0.1), (0.1, 0.8, 0.1)),
                   ((0.1, 0.3, 0.8), (0.8, 0.7, 0.1)),
                   ((0.7, 0.2, 0.7), (0.2, 0.7, 0.7))]
    copper = Material.solid((0.85, 0.45, 0.25), specular=0.45,
                            reflectivity=0.25)
    for i, (left_c, right_c) in enumerate(room_colors):
        cx = -9.0 + i * 9.0
        x0, x1, z0, z1 = cx - 3.0, cx + 3.0, -19.0, -13.0
        s.yz_rect(0.0, 5.0, z0, z1, x0, Material.solid(left_c))
        s.yz_rect(0.0, 5.0, z0, z1, x1, Material.solid(right_c))
        s.xy_rect(x0, x1, 0.0, 5.0, z0, white)
        s.xz_rect(x0, x1, z0, z1, 5.0, white)
        s.xz_rect(cx - 0.8, cx + 0.8, -16.8, -15.2, 4.99,
                  Material.emissive((1.2, 1.2, 1.2)))
        s.light((cx, 4.5, -16.0), (1, 1, 1), 25.0)
        if i == 0:
            s.sphere((cx, 1.0, -16.0), 1.0,
                     Material.solid((0.95, 0.95, 0.95), reflectivity=0.92))
        elif i == 1:
            s.box((cx - 0.7, 0.0, -16.7), (cx + 0.7, 1.4, -15.3), copper)
        else:
            s.sphere((cx, 1.0, -16.0), 1.0, Material.glass())
    pedestal = Material.solid((0.6, 0.6, 0.65), specular=0.1)
    gallery = [(icosphere(2), Material.solid((0.93, 0.91, 0.85),
                                             specular=0.10)),
               (torus(), Material.solid((0.35, 0.75, 0.55), specular=0.25,
                                        reflectivity=0.08)),
               (gem(), Material.solid((0.95, 0.78, 0.25), specular=0.5,
                                      reflectivity=0.35))]
    for i, (tris, mat) in enumerate(gallery):
        cx = -8.0 + i * 8.0
        s.cylinder((cx, 0.0, -8.0), 1.0, 0.0, 1.0, True, pedestal)
        s.mesh(on_floor(transform_mesh(tris, 1.6, (cx, 0.0, -8.0)), 1.0),
               mat)
    s.sphere((0.0, 1.5, -3.5), 1.0, Material.glass())
    s.light((0.0, 8.0, -6.0), (1.0, 0.97, 0.9), 220.0)
    s.light((-8.0, 6.0, -2.0), (0.9, 0.93, 1.0), 90.0)
    s.bg_top = (0.5, 0.7, 1.0)
    s.bg_bottom = (0.92, 0.95, 1.0)
    s.camera((0.0, 2.2, 3.0), pitch=-0.08, fov=65.0)
    return s.build()
