"""The engine main loop.

Copied from ``yetanotherconsolegameengine_tpu/engine/terminal.py``.
Counterpart of the C# Terminal (Renderer/Terminal.cs:23-365): owns the presentation backend (cycled with
'[' / ']'), the input poller, the entity list and the entity framebuffer;
each tick (``Terminal.tick``): dt -> input update -> key/mouse dispatch
-> debounced resize (125 ms) -> entity update (renders) -> compose +
backend render -> HUD. Esc / Ctrl-C stops. Spans (``utils/profiling.py``):
``tick``, ``tick.input``, ``tick.hud``.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

from ..utils import profiling
from .chexel import Framebuffer
from .entity import BaseEntity
from .input import TerminalInput
from .terminal_renderer import (BACKENDS, ANSITerminalRenderer,
                                TerminalRendererBase, enter_alt_screen,
                                leave_alt_screen)

RESIZE_DEBOUNCE_S = 0.125  # Terminal.cs:66-82


class Terminal:
    def __init__(self, backend: str = "ansi", enable_mouse: bool = False,
                 interactive: bool = True, out_fd: int = 1):
        self.out_fd = out_fd
        self.interactive = interactive
        if backend not in BACKENDS:
            # "window" registers only where pygame imports: say so rather
            # than show the frames on another backend.
            raise RuntimeError(
                f"backend {backend!r} is not available here (have "
                f"{sorted(BACKENDS)}); the window backend needs pygame")
        self.backend_names = list(BACKENDS)
        self.backend_idx = self.backend_names.index(backend)
        self.renderer: TerminalRendererBase = BACKENDS[backend](out_fd)
        self.input = TerminalInput(enable_mouse=enable_mouse) \
            if interactive else None
        self.entities: List[BaseEntity] = []
        self.running = False
        cols, lines = self.renderer.console_size()
        self.fb = Framebuffer(cols, max(1, lines - 1))  # last line = HUD
        self.renderer.add_framebuffer(self.fb)
        self._pending_resize: Optional[tuple] = None
        self._resize_at = 0.0
        self.fixed_size = False  # True disables resize-follow (--size)
        self.on_resize = None  # callback(fb)
        self.debug_string = ""
        self._fps = 0.0  # the HUD's smoothed rate

    def add_entity(self, e: BaseEntity) -> BaseEntity:
        e.input = self.input  # type: ignore[attr-defined]
        self.entities.append(e)
        return e

    # -- backend switching ('['/']', Terminal.cs:218-235) -------------------

    def cycle_backend(self, delta: int):
        self.backend_idx = (self.backend_idx + delta) % len(
            self.backend_names)
        old = self.renderer
        self.renderer = BACKENDS[self.backend_names[self.backend_idx]](
            self.out_fd)
        for fb in old.framebuffers:
            self.renderer.add_framebuffer(fb)
        old.close()

    # -- resize (debounced, Terminal.cs:66-82) ------------------------------

    def _check_resize(self, now: float):
        if self.fixed_size:
            return
        cols, lines = self.renderer.console_size()
        want = (cols, max(1, lines - 1))
        if (want[0], want[1]) != (self.fb.width, self.fb.height):
            if self._pending_resize != want:
                self._pending_resize = want
                self._resize_at = now + RESIZE_DEBOUNCE_S
            elif now >= self._resize_at:
                self.renderer.remove_framebuffer(self.fb)
                self.fb = Framebuffer(want[0], want[1])
                self.renderer.add_framebuffer(self.fb)
                self._pending_resize = None
                if self.on_resize:
                    self.on_resize(self.fb)
        else:
            self._pending_resize = None

    # -- the loop (Terminal.Start, Terminal.cs:126-184) ---------------------

    def start(self, max_frames: Optional[int] = None,
              target_fps: Optional[float] = None):
        self.running = True
        if self.interactive:
            enter_alt_screen(self.out_fd)
            self.input.start()
        last = time.perf_counter()
        frames = 0
        try:
            while self.running:
                now = time.perf_counter()
                dt = min(0.25, now - last)
                last = now
                self.tick(now, dt)
                frames += 1
                if max_frames is not None and frames >= max_frames:
                    self.running = False
                if target_fps:
                    sleep = (1.0 / target_fps) - (time.perf_counter() - now)
                    if sleep > 0:
                        time.sleep(sleep)
        finally:
            if self.interactive:
                self.input.stop()
                leave_alt_screen(self.out_fd)
            for e in self.entities:
                e.close()

    def tick(self, now: float, dt: float):
        """One pass of the loop that began at ``now`` (``perf_counter``),
        ``dt`` seconds after the last: keys and mouse, resize, the
        entities' update and draw, the backend's frame, the HUD line."""
        with profiling.span("tick"):
            if self.input is not None:
                with profiling.span("tick.input"):
                    self._dispatch_input()
            self._check_resize(now)
            for e in self.entities:
                e.update(dt)
            for e in self.entities:
                e.draw(self.fb)
            self.renderer.render()

            # FPS/HUD line on the reserved bottom row (Terminal.cs:163).
            with profiling.span("tick.hud"):
                ft = time.perf_counter() - now
                self._fps = 0.9 * self._fps + 0.1 * (1.0 / max(ft, 1e-6))
                hud = (f"\x1b[{self.fb.height + 1};1H\x1b[0m\x1b[K"
                       f" {self._fps:5.1f} fps | {ft * 1000.0:6.1f} ms | "
                       f"{self.renderer.name} | {self.debug_string}")
                os.write(self.out_fd, hud.encode())

    def _dispatch_input(self):
        self.input.update()
        # Windowed backends queue their own key events
        # (window_renderer.WindowTerminalRenderer._pump).
        win_keys = getattr(self.renderer, "try_get_key", None)
        while (key := self.input.try_get_key()
               or (win_keys() if win_keys else None)) is not None:
            if key in ("esc", "ctrl_c"):
                self.running = False
            elif key == "[":
                self.cycle_backend(-1)
            elif key == "]":
                self.cycle_backend(+1)
            else:
                for e in self.entities:
                    if e.handle_key(key):
                        break
        while (ev := self.input.try_get_mouse()) is not None:
            for e in self.entities:
                if e.handle_mouse(ev):
                    break

    def stop(self):
        self.running = False
