"""The bundled primitive and texture scenes, built with the numpy
SceneBuilder.

Port of ``yetanotherconsolegameengine_tpu/scene/builders.py``: the same
geometry, materials, lights, sky, textures and camera defaults, so each
table equals the JAX builder's element for element
(tests/test_torch_scene.py holds them equal). They are re-authored rather
than imported because the JAX builders return jnp arrays and import jax.
``SCENE_BUILDERS`` also registers the mesh scenes of
``scene/mesh_scenes.py``, the voxel scenes of ``scene/voxel_scenes.py``
and the museum of ``scene/showcase_scenes.py``, as the JAX registry does.
"""

from __future__ import annotations

import numpy as np

from .materials import PROC_TEXTURE, Material
from .mesh_scenes import MESH_SCENE_BUILDERS
from .showcase_scenes import SHOWCASE_SCENE_BUILDERS
from .tables import SceneBuilder, SceneData
from .voxel_scenes import VOXEL_SCENE_BUILDERS


def build_test_scene() -> SceneData:
    """Four spheres + two lights on a dark sky."""
    s = SceneBuilder("test")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.01
    red = Material.solid((1.0, 0.0, 0.0), specular=0.15)
    green = Material.solid((0.0, 1.0, 0.0), specular=0.15)
    blue = Material.solid((0.0, 0.0, 1.0), specular=0.15)
    mirror = Material.solid((0.98, 0.98, 0.98), reflectivity=0.9)
    r = 0.9
    s.add_sphere((-1.2, r, -2.2), r, red)
    s.add_sphere((1.2, r, -2.2), r, green)
    s.add_sphere((-1.2, r, -3.6), r, blue)
    s.add_sphere((1.2, r, -3.6), r, mirror)
    s.add_light((0.0, 3.2, -2.9), (1, 1, 1), 140.0)
    s.add_light((-2.2, 2.0, -2.4), (1, 1, 1), 60.0)
    s.bg_top = s.bg_bottom = (0.05, 0.05, 0.05)
    s.set_camera((0.0, 1.0, 0.0), fov=60.0)
    return s.build()


def build_cornell_box() -> SceneData:
    """The lighting reference scene."""
    s = SceneBuilder("cornell")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.0
    white = Material.solid((0.82, 0.82, 0.82))
    red = Material.solid((0.80, 0.10, 0.10))
    green = Material.solid((0.10, 0.80, 0.10))
    light_emit = Material.emissive((0.6, 0.6, 0.6))

    xl, xr, yb, yt, zf, zb = -3.0, 3.0, 0.0, 5.0, 0.0, -5.0
    s.add_yz_rect(yb, yt, zb, zf, xl, red)     # left wall
    s.add_yz_rect(yb, yt, zb, zf, xr, green)   # right wall
    s.add_xz_rect(xl, xr, zb, zf, yb, white)   # floor
    s.add_xz_rect(xl, xr, zb, zf, yt, white)   # ceiling
    s.add_xy_rect(xl, xr, yb, yt, zb, white)   # back wall
    s.add_xz_rect(-0.9, 0.9, -3.2, -2.2, yt - 0.01, light_emit)  # panel
    s.add_box((-2.2, 0.0, -4.0), (-0.8, 1.0, -2.8), white)
    s.add_box((0.6, 0.0, -3.3), (2.0, 1.8, -2.1), white)
    s.add_light((0.0, 4.6, -2.7), (1, 1, 1), 20.0)
    s.bg_top = s.bg_bottom = (0.0, 0.0, 0.0)
    s.set_camera((0.0, 1.0, 3.0), fov=60.0)
    return s.build()


def build_mirror_spheres() -> SceneData:
    """Mirror spheres on a checker XZ rect."""
    s = SceneBuilder("mirror_spheres")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.01
    floor = Material.checker((0.8, 0.8, 0.8), (0.15, 0.15, 0.15), 0.6,
                             specular=0.1)
    s.add_xz_rect(-8.0, 8.0, -8.0, 4.0, 0.0, floor)
    s.add_sphere((-1.2, 1.0, -2.0), 1.0,
                 Material.solid((1.0, 0.85, 0.57), specular=0.25, reflectivity=0.1))
    s.add_sphere((1.3, 1.0, -2.6), 1.0,
                 Material.solid((0.9, 0.95, 1.0), reflectivity=0.6))
    s.add_sphere((0.0, 0.5, -4.2), 0.5,
                 Material.solid((0.98, 0.98, 0.98), reflectivity=0.85))
    s.add_light((-2.5, 3.5, -1.5), (1.0, 0.95, 0.9), 90.0)
    s.add_light((2.0, 2.8, -3.8), (0.9, 0.95, 1.0), 70.0)
    s.bg_top = (0.55, 0.75, 1.0)
    s.bg_bottom = (0.95, 0.98, 1.0)
    s.set_camera((0.0, 1.0, 0.5), fov=60.0)
    return s.build()


def build_cylinders_disks_triangles() -> SceneData:
    """Primitive showcase: plane, cylinder, disk, triangle."""
    s = SceneBuilder("primitives")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.01
    floor = Material.checker((0.75, 0.75, 0.75), (0.2, 0.2, 0.2), 0.8,
                             specular=0.05)
    s.add_plane((0, 0, 0), (0, 1, 0), floor)
    s.add_cylinder((-1.2, 0.0, -3.0), 0.6, 0.0, 1.6, True,
                   Material.solid((0.2, 0.35, 0.9), specular=0.1))
    s.add_disk((1.6, 0.01, -2.2), (0, 1, 0), 0.9,
               Material.solid((0.8, 0.8, 0.1)))
    s.add_triangle((0.2, 0.0, -3.6), (1.3, 1.4, -3.0), (-0.7, 0.7, -2.8),
                   Material.solid((0.9, 0.25, 0.25), specular=0.1))
    s.add_light((-2.2, 3.2, -2.0), (1.0, 0.95, 0.9), 70.0)
    s.add_light((2.4, 2.2, -4.4), (0.9, 0.95, 1.0), 60.0)
    s.bg_top = (0.58, 0.78, 1.0)
    s.bg_bottom = (0.95, 0.98, 1.0)
    s.set_camera((0.0, 1.0, 0.5), fov=60.0)
    return s.build()


def build_boxes_showcase() -> SceneData:
    """Three boxes on a checker plane."""
    s = SceneBuilder("boxes")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.01
    floor = Material.checker((0.85, 0.85, 0.85), (0.15, 0.15, 0.15), 0.7,
                             specular=0.05)
    s.add_plane((0, 0, 0), (0, 1, 0), floor)
    white = Material.solid((0.86, 0.86, 0.86), specular=0.1)
    white_refl = Material.solid((0.86, 0.86, 0.86), specular=0.1,
                                reflectivity=0.4)
    s.add_box((-2.2, 0.0, -3.6), (-1.0, 1.2, -2.4), white)
    s.add_box((-0.6, 0.0, -4.2), (0.6, 0.6, -3.0), white_refl)
    s.add_box((1.0, 0.0, -3.0), (2.4, 2.0, -1.8),
              Material.solid((0.86, 0.86, 0.86)))
    s.add_light((-2.0, 3.0, -2.0), (1.0, 0.95, 0.9), 70.0)
    s.add_light((2.0, 2.5, -4.2), (0.9, 0.95, 1.0), 50.0)
    s.bg_top = (0.6, 0.8, 1.0)
    s.bg_bottom = (0.95, 0.98, 1.0)
    s.set_camera((0.0, 1.0, 0.5), fov=60.0)
    return s.build()


def _hsv_to_rgb(h, sat, v):
    c = v * sat
    hh = (h % 1.0) * 6.0
    x = c * (1.0 - abs(hh % 2.0 - 1.0))
    r, g, b = ((c, x, 0.0) if hh < 1 else (x, c, 0.0) if hh < 2
               else (0.0, c, x) if hh < 3 else (0.0, x, c) if hh < 4
               else (x, 0.0, c) if hh < 5 else (c, 0.0, x))
    m = v - c
    return (r + m, g + m, b + m)


def build_demo_scene(seed: int = 1337) -> SceneData:
    """Three hero spheres, a checker plane, an emissive ball and up to 100
    random spheres placed without overlap, from ``seed``."""
    s = SceneBuilder("demo_random")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.01
    s.add_sphere((-1.2, 1.0, 0.0), 1.0,
                 Material.solid((0.9, 0.2, 0.2), specular=0.25, reflectivity=0.2))
    s.add_sphere((1.2, 1.0, -0.5), 1.0,
                 Material.solid((0.2, 0.2, 0.9), specular=0.35, reflectivity=0.5))
    s.add_sphere((0.0, 0.5, -2.5), 0.5,
                 Material.solid((0.95, 0.95, 0.95), reflectivity=0.9))
    s.add_plane((0, 0, 0), (0, 1, 0),
                Material.checker((0.8, 0.8, 0.8), (0.1, 0.1, 0.1), 0.5))
    s.add_sphere((0.0, 5.0, 2.0), 0.5,
                 Material.solid((1.0, 1.0, 1.0), emission=(8.0, 8.0, 8.0)))
    s.add_light((-2.0, 4.0, 3.0), (1.0, 0.9, 0.8), 60.0)
    s.add_light((2.5, 3.5, -1.5), (0.8, 0.9, 1.0), 40.0)
    s.bg_top = (0.6, 0.8, 1.0)
    s.bg_bottom = (0.9, 0.95, 1.0)

    rng = np.random.RandomState(seed)
    placed = [((-1.2, 1.0, 0.0), 1.0), ((1.2, 1.0, -0.5), 1.0),
              ((0.0, 0.5, -2.5), 0.5)]
    for _ in range(100):
        for _attempt in range(32):
            radius = 0.18 + rng.rand() * 0.32
            x = -9.0 + rng.rand() * 9.0
            z = -9.8 + rng.rand() * 4.6
            center = (x, radius, z)
            ok = all((np.linalg.norm(np.subtract(center, c))
                      >= radius + r + 0.05) for c, r in placed)
            if not ok:
                continue
            rgb = _hsv_to_rgb(rng.rand(), 0.65 + rng.rand() * 0.35,
                              0.55 + rng.rand() * 0.45)
            spec = 0.10 + rng.rand() * 0.30
            refl = 0.6 if rng.rand() < 0.2 else 0.05
            s.add_sphere(center, radius,
                         Material.solid(rgb, specular=spec, reflectivity=refl))
            placed.append((center, radius))
            break
    s.set_camera((0.0, 1.5, 3.0), fov=60.0)
    return s.build()


def _synthetic_texture(n: int = 64) -> np.ndarray:
    """A colorful UV gradient with a grid, the stand-in image of the
    texture scenes."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) / (n - 1)
    img = np.stack([xx, yy, 0.25 + 0.75 * np.sin(6.28 * xx * 4) ** 2], -1)
    grid = ((np.floor(xx * 8) + np.floor(yy * 8)) % 2) == 0
    img[grid] *= 0.35
    return img.astype(np.float32)


def build_texture_test() -> SceneData:
    """A textured box under strong ambient light."""
    s = SceneBuilder("texture_test")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.5
    tid = s.add_texture(_synthetic_texture())
    tex_mat = Material(albedo=(0.5, 0.5, 0.5), proc=PROC_TEXTURE, tex_id=tid,
                       tex_weight=1.0, uv_scale=1.0)
    s.add_box((-0.5, -0.5, -2.5), (0.5, 0.5, -1.5), tex_mat)
    s.add_light((0.0, 2.0, 0.0), (1, 1, 1), 10.0)
    s.bg_top = s.bg_bottom = (0.0, 0.0, 0.0)
    s.set_camera((0.0, 0.0, 0.5), fov=60.0)
    return s.build()


def build_video_texture() -> SceneData:
    """Live video on a box: a synthetic animated reader feeds a texture
    slot that the renderer refreshes, and TAA resets every frame."""
    from ..video.readers import SyntheticReader

    s = SceneBuilder("video_texture")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.5
    tid = s.add_video_texture(SyntheticReader(width=128, height=72))
    tex_mat = Material(albedo=(0.5, 0.5, 0.5), proc=PROC_TEXTURE, tex_id=tid,
                       tex_weight=1.0, uv_scale=1.0)
    s.add_box((-0.8, -0.45, -2.5), (0.8, 0.45, -1.7), tex_mat)
    s.add_xz_rect(-6.0, 6.0, -6.0, 2.0, -0.55,
                  Material.checker((0.7, 0.7, 0.7), (0.25, 0.25, 0.25), 0.5))
    s.add_light((0.0, 2.0, 0.0), (1, 1, 1), 10.0)
    s.bg_top = s.bg_bottom = (0.02, 0.02, 0.03)
    s.set_camera((0.0, 0.0, 0.5), fov=60.0)
    return s.build()


def build_glass_showcase() -> SceneData:
    """Refractive spheres over a checker: the Fresnel reflect+refract path
    stack and colored shadow transmittance."""
    s = SceneBuilder("glass")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.02
    s.add_xz_rect(-8.0, 8.0, -8.0, 2.0, 0.0,
                  Material.checker((0.8, 0.8, 0.8), (0.15, 0.15, 0.15), 0.6))
    s.add_sphere((0.0, 1.1, -3.0), 1.0, Material.glass())
    s.add_sphere((-1.8, 0.6, -4.0), 0.6,
                 Material.solid((0.9, 0.3, 0.2), specular=0.2))
    s.add_sphere((1.8, 0.6, -4.0), 0.6,
                 Material.glass(transmission=(0.9, 0.4, 0.4), ior=1.33))
    s.add_light((0.0, 4.5, -1.0), (1, 1, 1), 120.0)
    s.bg_top = (0.55, 0.75, 1.0)
    s.bg_bottom = (0.95, 0.98, 1.0)
    s.set_camera((0.0, 1.2, 0.5), fov=60.0)
    return s.build()


SCENE_BUILDERS = {
    "test": build_test_scene,
    "cornell": build_cornell_box,
    "mirror_spheres": build_mirror_spheres,
    "primitives": build_cylinders_disks_triangles,
    "boxes": build_boxes_showcase,
    "demo_random": build_demo_scene,
    "texture_test": build_texture_test,
    "video_texture": build_video_texture,
    "glass": build_glass_showcase,
    **MESH_SCENE_BUILDERS,
    **VOXEL_SCENE_BUILDERS,
    **SHOWCASE_SCENE_BUILDERS,
}
