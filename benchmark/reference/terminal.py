"""A terminal screen fed an ANSI byte stream.

Understands what a frame writer sends a VT-style terminal: cursor
positioning ``CSI row;col H`` (1-based; missing numbers are 1), erase
display ``CSI 2 J`` (every cell blank with colours 0), SGR ``CSI ... m``
with ``38;5;n`` (foreground), ``48;5;n`` (background) and ``0`` or an
empty list (both reset to -1, "default"), and UTF-8 text, each character
written at the cursor in the current colours, the cursor then moving one
column right. Other sequences raise: the stream is held to this subset.
Cells off the screen are dropped.
"""

from __future__ import annotations

import re

import numpy as np

_CSI = re.compile(rb"\x1b\[([0-9;]*)([A-Za-z])")


class Screen:
    def __init__(self, glyph, fg, bg):
        """A screen that shows (glyph, fg, bg) int arrays of (rows, cols)."""
        self.glyph = np.array(glyph, np.int64)
        self.fg = np.array(fg, np.int64)
        self.bg = np.array(bg, np.int64)
        self.row = self.col = 0
        self.cur_fg = self.cur_bg = -1

    def _text(self, data: bytes):
        h, w = self.glyph.shape
        for ch in data.decode("utf-8"):
            if 0 <= self.row < h and 0 <= self.col < w:
                self.glyph[self.row, self.col] = ord(ch)
                self.fg[self.row, self.col] = self.cur_fg
                self.bg[self.row, self.col] = self.cur_bg
            self.col += 1

    def _sgr(self, params):
        nums = [int(p) if p else 0 for p in params.split(b";")] \
            if params else [0]
        i = 0
        while i < len(nums):
            if nums[i] == 0:
                self.cur_fg = self.cur_bg = -1
                i += 1
            elif nums[i] in (38, 48) and i + 2 < len(nums) \
                    and nums[i + 1] == 5:
                if nums[i] == 38:
                    self.cur_fg = nums[i + 2]
                else:
                    self.cur_bg = nums[i + 2]
                i += 3
            else:
                raise ValueError(f"unsupported SGR {params!r}")

    def feed(self, data: bytes):
        pos = 0
        for m in _CSI.finditer(data):
            if m.start() > pos:
                self._text(data[pos:m.start()])
            params, cmd = m.group(1), m.group(2)
            if cmd == b"H":
                nums = [int(p) if p else 1 for p in params.split(b";")] \
                    if params else [1, 1]
                self.row, self.col = nums[0] - 1, (nums + [1])[1] - 1
            elif cmd == b"m":
                self._sgr(params)
            elif cmd == b"J" and params == b"2":
                self.glyph[:] = 0x20
                self.fg[:] = 0
                self.bg[:] = 0
            else:
                raise ValueError(f"unsupported sequence {m.group(0)!r}")
            pos = m.end()
        if pos < len(data):
            self._text(data[pos:])
