"""The Cornell box of the C# scene table (Scenes.BuildCornellBox,
Scenes.cs:269-309): red and green side walls, white floor, ceiling and
back wall, an emissive ceiling panel, two white boxes and one point
light, seen from z = 3."""

from __future__ import annotations

from ..scene import Material, SceneBuilder, SceneInputs


def build() -> SceneInputs:
    s = SceneBuilder("cornell")
    s.ambient_color, s.ambient_intensity = (1, 1, 1), 0.0
    white = Material.solid((0.82, 0.82, 0.82))
    red = Material.solid((0.80, 0.10, 0.10))
    green = Material.solid((0.10, 0.80, 0.10))
    panel = Material.emissive((0.6, 0.6, 0.6))
    xl, xr, yb, yt, zf, zb = -3.0, 3.0, 0.0, 5.0, 0.0, -5.0
    s.yz_rect(yb, yt, zb, zf, xl, red)
    s.yz_rect(yb, yt, zb, zf, xr, green)
    s.xz_rect(xl, xr, zb, zf, yb, white)
    s.xz_rect(xl, xr, zb, zf, yt, white)
    s.xy_rect(xl, xr, yb, yt, zb, white)
    s.xz_rect(-0.9, 0.9, -3.2, -2.2, yt - 0.01, panel)
    s.box((-2.2, 0.0, -4.0), (-0.8, 1.0, -2.8), white)
    s.box((0.6, 0.0, -3.3), (2.0, 1.8, -2.1), white)
    s.light((0.0, 4.6, -2.7), (1, 1, 1), 20.0)
    s.bg_top = s.bg_bottom = (0.0, 0.0, 0.0)
    s.camera((0.0, 1.0, 3.0), fov=60.0)
    return s.build()
