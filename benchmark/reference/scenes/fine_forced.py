"""The program's small cluster scene with all three proxy sets (the scene
of its ``fine_forced`` golden, ``scene/mesh_scenes.py::
build_fine_forced_scene``): a 5,120-triangle icosphere on a checker floor
under one light, forced onto cluster tables with fine, LOD and shadow
proxy sets of 2,048, 512 and 128 triangles at most."""

from __future__ import annotations

from ..scene import Material, SceneBuilder, SceneInputs, icosphere, \
    transform_mesh


def build() -> SceneInputs:
    s = SceneBuilder("fine_forced")
    s.xz_rect(-6.0, 6.0, -6.0, 3.0, 0.0,
              Material.checker((0.8, 0.8, 0.8), (0.2, 0.2, 0.2), 0.8))
    s.light((2.5, 4.0, 1.5), (1.0, 0.95, 0.9), 70.0)
    s.mesh(transform_mesh(icosphere(4), 1.3, (0.0, 0.9, -2.4)),
           Material.solid((0.85, 0.7, 0.55)))
    s.force_clusters({"fine": 2048, "lod": 512, "shadow": 128})
    s.camera((0.0, 1.3, 1.2), fov=60.0)
    return s.build()
