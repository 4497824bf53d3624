"""Terminal presentation backends.

Copied from ``yetanotherconsolegameengine_tpu/engine/terminal_renderer.py``,
on the port's ``native`` encoder. Counterparts of the C# ITerminalRenderer
family (Renderer/Terminal.cs:15-21 and the ANSI / plain / Win32 backends).
POSIX replaces Win32: the perf trick preserved is the C# single-syscall frame write (ANSITerminalRenderer.Flush,
ANSITerminalRenderer.cs:226-242) — the whole frame is encoded into one
byte buffer (C++ run-length SGR encoder via ctypes, numpy/Python fallback)
and written with one ``os.write``. A diff backend goes further than the
C# one: only cells that changed since the last frame are re-encoded.
"""

from __future__ import annotations

import ctypes
import os
import sys
from typing import List, Optional

import numpy as np

from ..native import load as load_native
from ..utils import profiling
from .chexel import Framebuffer, compose

ESC = b"\x1b"


class TerminalRendererBase:
    """Backend interface (ITerminalRenderer: console size, framebuffer
    stack, Render)."""

    name = "base"

    def __init__(self, out_fd: int = 1):
        self.out_fd = out_fd
        self.framebuffers: List[Framebuffer] = []

    def add_framebuffer(self, fb: Framebuffer):
        if fb not in self.framebuffers:
            self.framebuffers.append(fb)

    def remove_framebuffer(self, fb: Framebuffer):
        if fb in self.framebuffers:
            self.framebuffers.remove(fb)

    def console_size(self):
        try:
            sz = os.get_terminal_size(self.out_fd)
            if sz.columns > 0 and sz.lines > 0:
                return sz.columns, sz.lines
        except OSError:
            pass
        return 80, 24

    def render(self):
        raise NotImplementedError

    def close(self):
        pass


def _py_encode(glyph: np.ndarray, fg: np.ndarray, bg: np.ndarray,
               origin_row: int) -> bytes:
    """Pure-Python fallback mirroring yacge_ansi_encode (run-length SGR)."""
    parts: List[bytes] = []
    cur_fg = cur_bg = -1
    h, w = glyph.shape
    for y in range(h):
        parts.append(b"\x1b[%d;1H" % (origin_row + y))
        row = []
        gf, gg, gb = glyph[y], fg[y], bg[y]
        for x in range(w):
            if gg[x] != cur_fg:
                cur_fg = int(gg[x])
                row.append(b"\x1b[38;5;%dm" % cur_fg)
            if gb[x] != cur_bg:
                cur_bg = int(gb[x])
                row.append(b"\x1b[48;5;%dm" % cur_bg)
            row.append(chr(int(gf[x])).encode("utf-8"))
        parts.append(b"".join(row))
    parts.append(b"\x1b[0m")
    return b"".join(parts)


class ANSITerminalRenderer(TerminalRendererBase):
    """256-color ANSI backend, one write per frame
    (ANSITerminalRenderer.cs:7-398)."""

    name = "ansi"

    def __init__(self, out_fd: int = 1, diff: bool = True):
        super().__init__(out_fd)
        self.diff = diff
        self._lib = load_native()
        self._buf: Optional[ctypes.Array] = None
        self._prev: Optional[tuple] = None
        self._size = None

    def _encode_native(self, g, f, b, origin_row: int) -> Optional[bytes]:
        lib = self._lib
        if lib is None:
            return None
        h, w = g.shape
        need = lib.yacge_ansi_max_bytes(w, h)
        if self._buf is None or len(self._buf) < need:
            self._buf = (ctypes.c_uint8 * need)()
        p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        if self.diff and self._prev is not None \
                and self._prev[0].shape == g.shape:
            pg, pf, pb = self._prev
            n = lib.yacge_ansi_encode_diff(p(g), p(f), p(b), p(pg), p(pf),
                                           p(pb), w, h, origin_row, self._buf)
            if n < 0:
                return b""
        else:
            n = lib.yacge_ansi_encode(p(g), p(f), p(b), w, h, origin_row,
                                      self._buf)
        return bytes(self._buf[:n])

    def render(self):
        cols, lines = self.console_size()
        if self._size != (cols, lines):
            # Terminal resized: full clear + full re-encode.
            self._size = (cols, lines)
            self._prev = None
            os.write(self.out_fd, b"\x1b[2J")
        with profiling.span("present.compose"):
            fb = compose(self.framebuffers, cols, lines)
            g = np.ascontiguousarray(fb.glyph)
            f = np.ascontiguousarray(fb.fg_ansi)
            b = np.ascontiguousarray(fb.bg_ansi)
        with profiling.span("present.encode"):
            data = self._encode_native(g, f, b, 1)
            if data is None:
                data = _py_encode(g, f, b, 1)
        if data:
            with profiling.span("present.write"):
                os.write(self.out_fd, data)  # the single-syscall frame write
        self._prev = (g, f, b)


class PlainTerminalRenderer(TerminalRendererBase):
    """Baseline backend: buffered sys.stdout writes, no escape batching —
    the reference's TerminalRenderer ("Console.Write") for comparison."""

    name = "plain"

    def render(self):
        cols, lines = self.console_size()
        fb = compose(self.framebuffers, cols, lines)
        out = []
        for y in range(lines):
            out.append("\x1b[%d;1H" % (y + 1))
            for x in range(cols):
                out.append("\x1b[38;5;%dm\x1b[48;5;%dm%c" % (
                    fb.fg_ansi[y, x], fb.bg_ansi[y, x],
                    chr(int(fb.glyph[y, x]))))
        out.append("\x1b[0m")
        sys.stdout.write("".join(out))
        sys.stdout.flush()


def enter_alt_screen(fd: int = 1):
    os.write(fd, b"\x1b[?1049h\x1b[?25l\x1b[2J")  # alt screen, hide cursor


def leave_alt_screen(fd: int = 1):
    os.write(fd, b"\x1b[0m\x1b[?25h\x1b[?1049l")


BACKENDS = {
    "ansi": ANSITerminalRenderer,
    "plain": PlainTerminalRenderer,
}

# The windowed (SDL) backend registers when pygame can load — the cycle
# keys ('['/']') then reach it, closing the reference's
# OpenGLTerminalRenderer capability on Linux (coverage row #49).
try:
    from .window_renderer import WindowTerminalRenderer, available as \
        _window_available
    if _window_available():
        BACKENDS["window"] = WindowTerminalRenderer
except Exception:  # pygame missing/broken: terminal backends only
    pass
