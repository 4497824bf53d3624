"""Mesh showcase scenes and the two forced cluster scenes of the goldens.

Port of ``yetanotherconsolegameengine_tpu/scene/mesh_scenes.py``: each
scene drops one (or all) hero meshes on a checker floor with a palette of
plastic materials and sits the mesh on the ground. Stanford OBJ assets are
loaded when ``find_asset`` finds them; otherwise procedural stand-ins keep
the scenes self-contained. Of these only ``dragon`` (~600k triangles)
reaches the cluster-mesh path; the stand-ins of the others (bunny 1,280
triangles to all_meshes 6,476) are under ``CLUSTER_MIN_TRIS`` and build an
LBVH. A real OBJ of at least 16,384 triangles, such as the 69k-triangle
Stanford bunny, takes the cluster path.

``build_cluster_forced_scene`` and ``build_fine_forced_scene`` are numpy
ports of the scenes behind the ``cluster_forced`` and ``fine_forced``
goldens (the JAX package's ``parallel/sharding.py::cluster_test_scene`` and
``tests/golden_gen.py::_fine_forced_scene``): small icospheres forced onto
the cluster path, the second with fine/LOD/shadow proxy sets built at toy
budgets.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .materials import Material
from .mesh_loader import (find_asset, load_obj, make_dragon, make_gem,
                          make_icosphere, make_knot, make_torus, mesh_bounds,
                          transform_mesh)
from .lod import simplify_soup
from .tables import PROXY_KC, SceneBuilder, SceneData
from ..ops.mesh_clusters import build_clusters

# Plastic materials aligned to the console palette.
SWATCH = {
    "ivory": Material.solid((0.93, 0.91, 0.85), specular=0.10),
    "jade": Material.solid((0.35, 0.75, 0.55), specular=0.25, reflectivity=0.08),
    "copper": Material.solid((0.85, 0.45, 0.25), specular=0.45, reflectivity=0.25),
    "slate": Material.solid((0.35, 0.38, 0.42), specular=0.15),
    "gold": Material.solid((0.95, 0.78, 0.25), specular=0.5, reflectivity=0.35),
    "glass": Material.glass(reflectivity=0.04, ior=1.5),
}


def _mesh_or_fallback(asset: str, fallback, scale: float, at,
                      normalize: bool = True) -> np.ndarray:
    path = find_asset(asset)
    if path is not None:
        return load_obj(path, normalize=normalize, scale=scale, translate=at)
    return transform_mesh(fallback(), normalize=normalize, scale=scale,
                          translate=at)


def _auto_ground(tris: np.ndarray, floor_y: float = 0.0) -> np.ndarray:
    """Translate so the mesh's min-Y sits on the floor."""
    lo, _ = mesh_bounds(tris)
    return tris + np.asarray([0.0, floor_y - lo[1], 0.0], np.float32)


def _stage(s: SceneBuilder):
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.04
    s.add_xz_rect(-12.0, 12.0, -12.0, 6.0, 0.0,
                  Material.checker((0.82, 0.82, 0.82), (0.2, 0.2, 0.2), 0.75,
                                   specular=0.05))
    s.add_light((2.5, 5.0, 2.0), (1.0, 0.97, 0.9), 120.0)
    s.add_light((-3.0, 4.0, -1.0), (0.85, 0.9, 1.0), 60.0)
    s.bg_top = (0.55, 0.75, 1.0)
    s.bg_bottom = (0.95, 0.98, 1.0)


def _single_mesh_scene(name: str, asset: Optional[str], fallback,
                       mat: Material, scale: float = 2.0) -> SceneData:
    s = SceneBuilder(name)
    _stage(s)
    if asset is not None:
        tris = _mesh_or_fallback(asset, fallback, scale, (0.0, 0.0, -3.5))
    else:
        tris = transform_mesh(fallback(), normalize=True, scale=scale,
                              translate=(0.0, 0.0, -3.5))
    tris = _auto_ground(tris)
    s.add_mesh_triangles(tris, mat)
    s.set_camera((0.0, 1.6, 1.5), fov=60.0)
    return s.build()


def build_bunny_scene() -> SceneData:
    """Stanford bunny; icosphere stand-in when the asset is absent."""
    return _single_mesh_scene("bunny", "stanford-bunny.obj",
                              lambda: make_icosphere(3), SWATCH["ivory"])


def build_teapot_scene() -> SceneData:
    """Utah teapot; torus stand-in."""
    return _single_mesh_scene("teapot", "teapot.obj",
                              lambda: make_torus(), SWATCH["copper"])


def build_cow_scene() -> SceneData:
    """Cow mesh; torus-knot stand-in."""
    return _single_mesh_scene("cow", "cow.obj",
                              lambda: make_knot(), SWATCH["jade"])


def build_dragon_scene() -> SceneData:
    """xyzrgb dragon; the stand-in is ``make_dragon``, a ~600k-triangle
    procedural hero mesh of the same order as the real asset. It builds
    the full cluster set (kc=256) and fine, LOD and shadow proxy sets."""
    return _single_mesh_scene("dragon", "xyzrgb_dragon.obj",
                              make_dragon, SWATCH["gold"], scale=2.6)


def build_glass_gem_scene() -> SceneData:
    """Faceted refractive mesh — exercises triangle + Fresnel paths."""
    return _single_mesh_scene("glass_gem", None, lambda: make_gem(),
                              SWATCH["glass"], scale=1.6)


def build_all_meshes_scene() -> SceneData:
    """Every hero mesh in a ring."""
    s = SceneBuilder("all_meshes")
    _stage(s)
    entries = [
        ("stanford-bunny.obj", lambda: make_icosphere(2), SWATCH["ivory"], 1.6),
        ("teapot.obj", lambda: make_torus(), SWATCH["copper"], 1.6),
        ("cow.obj", lambda: make_knot(), SWATCH["jade"], 1.6),
        (None, lambda: make_gem(), SWATCH["glass"], 1.2),
    ]
    radius = 2.8
    for i, (asset, fb, mat, scale) in enumerate(entries):
        ang = i * (2.0 * math.pi / len(entries)) + math.pi / 4
        at = (radius * math.cos(ang), 0.0, -4.0 + radius * math.sin(ang))
        if asset is not None:
            tris = _mesh_or_fallback(asset, fb, scale, at)
        else:
            tris = transform_mesh(fb(), normalize=True, scale=scale,
                                  translate=at)
        s.add_mesh_triangles(_auto_ground(tris), mat)
    s.add_sphere((0.0, 1.0, -4.0), 1.0,
                 Material.solid((0.95, 0.95, 0.95), reflectivity=0.92))
    s.set_camera((0.0, 2.2, 1.5), pitch=-0.18, fov=60.0)
    return s.build()


def build_cluster_forced_scene(subdiv: int = 3) -> SceneData:
    """A small scene forced onto the cluster path (the ``cluster_forced``
    golden renders subdiv=3): an icosphere mesh beside a mirror and a glass
    sphere, so paths live past round 2 and the refraction stack is used."""
    s = SceneBuilder("cluster_shard_test")
    s.add_xz_rect(-6.0, 6.0, -6.0, 3.0, 0.0,
                  Material.checker((0.8, 0.8, 0.8), (0.2, 0.2, 0.2), 0.8))
    s.add_light((2.0, 4.0, 2.0), (1.0, 1.0, 1.0), 60.0)
    s.add_sphere((1.6, 0.6, -2.0), 0.6,
                 Material.solid((0.95, 0.95, 0.95), reflectivity=1.0))
    s.add_sphere((-1.5, 0.5, -1.2), 0.5, Material.glass())
    tris = transform_mesh(make_icosphere(subdiv), normalize=True, scale=1.4,
                          translate=(0.0, 0.9, -2.5))
    s.add_mesh_triangles(tris, Material.solid((0.9, 0.85, 0.8)))
    mid = s._mesh_tris[-1][1]
    s.set_camera((0.0, 1.2, 1.0), fov=60.0)
    mc = build_clusters(tris[:, 0], tris[:, 1], tris[:, 2],
                        np.full(tris.shape[0], mid, np.int32))
    return s.build(clusters=dict(mesh_clusters=mc))


def build_fine_forced_scene() -> SceneData:
    """The dragon's proxy routing at toy scale (the ``fine_forced``
    golden): a 5.1k-triangle icosphere with fine, LOD and shadow cluster
    sets built at tiny budgets (``forced_cluster_sets``)."""
    s = SceneBuilder("fine_forced")
    s.add_xz_rect(-6.0, 6.0, -6.0, 3.0, 0.0,
                  Material.checker((0.8, 0.8, 0.8), (0.2, 0.2, 0.2), 0.8))
    s.add_light((2.5, 4.0, 1.5), (1.0, 0.95, 0.9), 70.0)
    tris = transform_mesh(make_icosphere(4), normalize=True, scale=1.3,
                          translate=(0.0, 0.9, -2.4))
    s.add_mesh_triangles(tris, Material.solid((0.85, 0.7, 0.55)))
    mid = s._mesh_tris[-1][1]
    s.set_camera((0.0, 1.3, 1.2), fov=60.0)

    return s.build(clusters=forced_cluster_sets(
        tris, np.full(tris.shape[0], mid, np.int32)))


def forced_cluster_sets(tris: np.ndarray, mats: np.ndarray,
                        fine: int = 2048, lod: int = 512,
                        shadow: int = 128) -> dict:
    """Cluster tables of a mesh of any size, with fine, LOD and shadow
    proxy sets of at most ``fine``, ``lod`` and ``shadow`` triangles and
    composed t_biases (lod = LOD + fine, shadow = LOD + fine + shadow):
    ``SceneBuilder.build``'s ``clusters`` for a small test scene."""
    full = build_clusters(tris[:, 0], tris[:, 1], tris[:, 2], mats)
    f_tris, f_mats, fine_bias = simplify_soup(tris, mats, fine)
    fine_set = build_clusters(f_tris[:, 0], f_tris[:, 1], f_tris[:, 2],
                              f_mats, kc=PROXY_KC)
    l_tris, l_mats, lod_bias = simplify_soup(tris, mats, lod)
    lod_set = build_clusters(l_tris[:, 0], l_tris[:, 1], l_tris[:, 2],
                             l_mats, t_bias=lod_bias + fine_bias,
                             kc=PROXY_KC)
    sh_tris, sh_mats, sh_bias = simplify_soup(l_tris, l_mats, shadow)
    shadow_set = build_clusters(
        sh_tris[:, 0], sh_tris[:, 1], sh_tris[:, 2], sh_mats,
        t_bias=lod_bias + fine_bias + sh_bias, kc=PROXY_KC)
    return dict(mesh_clusters=full, mesh_clusters_fine=fine_set,
                mesh_clusters_lod=lod_set, mesh_clusters_shadow=shadow_set)


FORCED_SCENE_BUILDERS = {
    "cluster_forced": build_cluster_forced_scene,
    "fine_forced": build_fine_forced_scene,
}

MESH_SCENE_BUILDERS = {
    "bunny": build_bunny_scene,
    "teapot": build_teapot_scene,
    "cow": build_cow_scene,
    "dragon": build_dragon_scene,
    "glass_gem": build_glass_gem_scene,
    "all_meshes": build_all_meshes_scene,
}
