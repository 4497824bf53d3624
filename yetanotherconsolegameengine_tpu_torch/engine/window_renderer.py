"""Windowed presentation backend (SDL via pygame).

Copied from ``yetanotherconsolegameengine_tpu/engine/window_renderer.py``.
Counterpart of the C# OpenGLTerminalRenderer
(Renderer/OpenGLTerminalRenderer.cs:13-417): the cell grid is composed into a (cells_w, cells_h*2) RGB pixel image —
each cell contributes its fg color as the top pixel and its bg color as
the bottom pixel, linear->sRGB encoded (:118-149, LinearToSrgb8 :391-404)
— uploaded as a texture and blitted to the window with aspect-preserving
letterboxing (UpdateViewport :356-388). The mouse wheel resizes the CELL
GRID (not the window): +-4 columns / +-2 rows per notch, clamped to
[40, 400] x [15, 200] (:238-251); the engine follows via console_size()
-> Terminal's debounced resize, exactly how the reference's onResize
callback flows.

Differences from the reference, by design:
- pygame/SDL2 instead of OpenTK/GL4 (this host is Linux; SDL's "dummy"
  video driver also makes the backend testable headless, which the
  reference's window is not).
- The compose loop is vectorized numpy over the SoA framebuffer planes
  instead of a row-sliced thread pool over Chexel structs — one
  `surfarray.blit_array` replaces the GL texture upload.
- Keyboard/quit events from the window feed the shared key queue so the
  window is usable standalone; the reference reads only console input.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .terminal_renderer import TerminalRendererBase
from .chexel import compose

MIN_CELLS_W, MIN_CELLS_H = 40, 15     # OpenGLTerminalRenderer.cs:39-42
MAX_CELLS_W, MAX_CELLS_H = 400, 200


def _srgb8(c: np.ndarray) -> np.ndarray:
    """Vectorized LinearToSrgb8 (OpenGLTerminalRenderer.cs:391-404)."""
    v = np.clip(c, 0.0, 1.0)
    s = np.where(v <= 0.0031308, 12.92 * v,
                 1.055 * np.power(v, 1.0 / 2.4) - 0.055)
    return np.clip(np.rint(s * 255.0), 0, 255).astype(np.uint8)


def available() -> bool:
    """True when pygame/SDL can initialize a video driver here (a real
    display, or SDL's dummy driver as the headless fallback)."""
    try:
        import pygame  # noqa: F401
        return True
    except Exception:
        return False


class WindowTerminalRenderer(TerminalRendererBase):
    """Half-block cell grid in an SDL window, wheel-resizable grid."""

    name = "window"

    def __init__(self, out_fd: int = 1, cells_w: int = 120,
                 cells_h: int = 40, scale: int = 8,
                 title: str = "YACGE window renderer"):
        super().__init__(out_fd)
        self.cells_w = max(MIN_CELLS_W, min(MAX_CELLS_W, cells_w))
        self.cells_h = max(MIN_CELLS_H, min(MAX_CELLS_H, cells_h))
        self.scale = max(1, min(64, scale))  # px per half-cell (:36-37)
        self.title = title
        self._pg = None
        self._screen = None
        self._keys: list = []          # drained by WindowInput
        self.frames_rendered = 0

    # -- lazy window init (EnsureInitialized, :203-236) -----------------

    def _ensure_init(self):
        if self._pg is not None:
            return
        if not os.environ.get("DISPLAY") \
                and not os.environ.get("WAYLAND_DISPLAY"):
            os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
        import pygame
        pygame.display.init()
        w = self.cells_w * self.scale
        h = self.cells_h * 2 * self.scale
        self._screen = pygame.display.set_mode((w, h), pygame.RESIZABLE)
        pygame.display.set_caption(self.title)
        self._pg = pygame

    # -- the grid is the console (consoleWidth/Height, :16-17) ----------

    def console_size(self):
        return self.cells_w, self.cells_h

    def set_grid_size(self, cells_w: int, cells_h: int):
        """SetGridSize (:87-99): clamp; the engine picks the change up on
        its next console_size() poll (debounced resize)."""
        self.cells_w = max(MIN_CELLS_W, min(MAX_CELLS_W, cells_w))
        self.cells_h = max(MIN_CELLS_H, min(MAX_CELLS_H, cells_h))

    def _on_wheel(self, step: int):
        """OnMouseWheelEvent (:238-251): +-4 cols / +-2 rows per notch."""
        if step:
            self.set_grid_size(self.cells_w + step * 4,
                               self.cells_h + step * 2)

    # -- events ---------------------------------------------------------

    def _pump(self):
        pg = self._pg
        for ev in pg.event.get():
            if ev.type == pg.QUIT:
                self._keys.append("esc")
            elif ev.type == pg.MOUSEWHEEL:
                self._on_wheel(1 if ev.y > 0 else (-1 if ev.y < 0 else 0))
            elif ev.type == pg.KEYDOWN:
                name = pg.key.name(ev.key)
                if len(name) == 1:
                    self._keys.append(name)
                elif name in ("escape",):
                    self._keys.append("esc")
                elif name in ("up", "down", "left", "right", "space"):
                    self._keys.append(name if name != "space" else " ")

    def try_get_key(self) -> Optional[str]:
        return self._keys.pop(0) if self._keys else None

    # -- frame (Render, :101-158) ---------------------------------------

    def compose_pixels(self) -> np.ndarray:
        """The (cells_h*2, cells_w, 3) u8 image: fg color on even rows,
        bg on odd (:127-146). Exposed separately for the headless test."""
        fb = compose(self.framebuffers, self.cells_w, self.cells_h)
        px = np.empty((self.cells_h * 2, self.cells_w, 3), np.uint8)
        px[0::2] = _srgb8(fb.fg_rgb)
        px[1::2] = _srgb8(fb.bg_rgb)
        return px

    def render(self):
        self._ensure_init()
        self._pump()
        px = self.compose_pixels()
        pg = self._pg
        src = pg.Surface((px.shape[1], px.shape[0]))
        pg.surfarray.blit_array(src, px.transpose(1, 0, 2))
        # Aspect-preserving letterbox (UpdateViewport, :356-388).
        win_w, win_h = self._screen.get_size()
        src_aspect = px.shape[1] / px.shape[0]
        win_aspect = win_w / max(1, win_h)
        if win_aspect > src_aspect:
            vp_h, vp_w = win_h, max(1, round(win_h * src_aspect))
        else:
            vp_w, vp_h = win_w, max(1, round(win_w / src_aspect))
        vp_x, vp_y = (win_w - vp_w) // 2, (win_h - vp_h) // 2
        self._screen.fill((0, 0, 0))
        self._screen.blit(
            pg.transform.scale(src, (vp_w, vp_h)), (vp_x, vp_y))
        pg.display.flip()
        self.frames_rendered += 1

    def close(self):
        if self._pg is not None:
            self._pg.display.quit()
            self._pg = None
            self._screen = None
