"""Chexel framebuffers as numpy tables.

Copied from ``yetanotherconsolegameengine_tpu/engine/chexel.py``. The
C# original's Framebuffer is a 2-D grid of Chexel structs (glyph +
ChexelColor fg/bg carrying both a quantized console color and full float
RGB, Renderer/Chexel.cs:6-125, Framebuffer.cs:8-101). Here a framebuffer is SoA numpy planes — glyph
codepoints (i32), float RGB fg/bg, and cached ANSI-256 indices — so whole-
frame device outputs land with one vectorized assignment and backends
encode without per-cell Python.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

HALF_BLOCK = 0x2580  # '▀' — top half block (fg = top px, bg = bottom px)
SPACE = 0x20


@dataclasses.dataclass
class Framebuffer:
    """SoA chexel grid with a viewport offset (Framebuffer.cs:8-50)."""

    width: int
    height: int
    offset_x: int = 0
    offset_y: int = 0

    def __post_init__(self):
        self.glyph = np.full((self.height, self.width), SPACE, np.int32)
        self.fg_rgb = np.zeros((self.height, self.width, 3), np.float32)
        self.bg_rgb = np.zeros((self.height, self.width, 3), np.float32)
        self.fg_ansi = np.zeros((self.height, self.width), np.int32)
        self.bg_ansi = np.zeros((self.height, self.width), np.int32)

    def clear(self, glyph: int = SPACE):
        self.glyph[:] = glyph
        self.fg_rgb[:] = 0.0
        self.bg_rgb[:] = 0.0
        self.fg_ansi[:] = 0
        self.bg_ansi[:] = 0

    def set_chexel(self, x: int, y: int, glyph: int, fg_rgb, bg_rgb,
                   fg_ansi: int = 0, bg_ansi: int = 0):
        if 0 <= x < self.width and 0 <= y < self.height:
            self.glyph[y, x] = glyph
            self.fg_rgb[y, x] = fg_rgb
            self.bg_rgb[y, x] = bg_rgb
            self.fg_ansi[y, x] = fg_ansi
            self.bg_ansi[y, x] = bg_ansi

    def blit_half_blocks(self, top_rgb, bot_rgb, fg_ansi, bg_ansi):
        """Whole-frame assignment from a device FrameOutput: every cell a
        '▀' with (top, bottom) colors (RaytraceRenderer.cs:229-264)."""
        h = min(self.height, np.asarray(top_rgb).shape[0])
        w = min(self.width, np.asarray(top_rgb).shape[1])
        self.glyph[:h, :w] = HALF_BLOCK
        self.fg_rgb[:h, :w] = np.asarray(top_rgb)[:h, :w]
        self.bg_rgb[:h, :w] = np.asarray(bot_rgb)[:h, :w]
        self.fg_ansi[:h, :w] = np.asarray(fg_ansi)[:h, :w]
        self.bg_ansi[:h, :w] = np.asarray(bg_ansi)[:h, :w]

    def write_text(self, x: int, y: int, text: str, fg=(1.0, 1.0, 1.0),
                   bg=(0.0, 0.0, 0.0), fg_ansi: int = 15, bg_ansi: int = 0):
        """Debug/HUD text (Terminal.SetDebugString role)."""
        for i, ch in enumerate(text):
            self.set_chexel(x + i, y, ord(ch), fg, bg, fg_ansi, bg_ansi)

    def to_png(self, path: str, scale: int = 4):
        """Golden-image export (Framebuffer.ToPng, Framebuffer.cs:51-100)."""
        from ..utils.png import frame_to_image, write_png
        img = frame_to_image(self.fg_rgb, self.bg_rgb, scale=scale)
        write_png(path, img)


def compose(buffers, width: int, height: int) -> Framebuffer:
    """Front-to-back framebuffer stack: first non-space glyph wins
    (ANSITerminalRenderer.GetChexelForPoint, ANSITerminalRenderer.cs:67-84).
    ``buffers`` is ordered front first."""
    out = Framebuffer(width, height)
    filled = np.zeros((height, width), bool)
    for fb in buffers:
        y0, x0 = fb.offset_y, fb.offset_x
        y1 = min(height, y0 + fb.height)
        x1 = min(width, x0 + fb.width)
        if y1 <= y0 or x1 <= x0:
            continue
        src_h, src_w = y1 - y0, x1 - x0
        region = (slice(y0, y1), slice(x0, x1))
        src = (slice(0, src_h), slice(0, src_w))
        take = (~filled[region]) & (fb.glyph[src] != SPACE)
        for plane in ("glyph", "fg_ansi", "bg_ansi"):
            getattr(out, plane)[region][take] = getattr(fb, plane)[src][take]
        out.fg_rgb[region][take] = fb.fg_rgb[src][take]
        out.bg_rgb[region][take] = fb.bg_rgb[src][take]
        filled[region] |= take
    return out
