"""Terminal input: termios raw mode + escape-sequence parsing.

Copied from ``yetanotherconsolegameengine_tpu/engine/input.py``. POSIX
counterpart of the C# TerminalInput (Renderer/TerminalInput.cs:9-526),
which polls
GetAsyncKeyState and hooks WH_MOUSE_LL on Windows. Here stdin is switched
to raw non-blocking mode; ``update()`` drains pending bytes each frame
into a key-event queue and maintains an ``is_key_down`` emulation (a key
is "down" for a short hold window after its last repeat — terminals only
deliver key *repeats*, not up/down transitions). SGR mouse reports
(``\\x1b[<b;x;yM``) are parsed into mouse events when enabled.
"""

from __future__ import annotations

import dataclasses
import os
import select
import sys
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

# Symbolic key names for escape sequences.
KEY_UP = "up"
KEY_DOWN = "down"
KEY_LEFT = "left"
KEY_RIGHT = "right"
KEY_ESC = "esc"

_ESC_MAP = {
    b"[A": KEY_UP, b"[B": KEY_DOWN, b"[C": KEY_RIGHT, b"[D": KEY_LEFT,
    b"OA": KEY_UP, b"OB": KEY_DOWN, b"OC": KEY_RIGHT, b"OD": KEY_LEFT,
}

# is_key_down hold window (seconds): long enough to bridge the terminal's
# key-repeat delay so held movement keys read as continuously down.
HOLD_S = 0.55


@dataclasses.dataclass(frozen=True)
class MouseEvent:
    """SGR mouse report (button, x, y, pressed, wheel)."""

    button: int
    x: int
    y: int
    pressed: bool
    wheel: int = 0


class TerminalInput:
    def __init__(self, fd: Optional[int] = None, enable_mouse: bool = False):
        self.fd = fd if fd is not None else sys.stdin.fileno()
        self.enable_mouse = enable_mouse
        self._keys: Deque[str] = deque()
        self._mouse: Deque[MouseEvent] = deque()
        self._down: Dict[str, float] = {}
        self._old_attrs = None
        self._pending = b""

    # -- raw mode -----------------------------------------------------------

    def start(self):
        try:
            import termios
            import tty
            self._old_attrs = termios.tcgetattr(self.fd)
            tty.setraw(self.fd, termios.TCSANOW)
        except Exception:
            self._old_attrs = None
        if self.enable_mouse:
            os.write(1, b"\x1b[?1003h\x1b[?1006h")  # any-event + SGR mode

    def stop(self):
        if self.enable_mouse:
            os.write(1, b"\x1b[?1003l\x1b[?1006l")
        if self._old_attrs is not None:
            import termios
            termios.tcsetattr(self.fd, termios.TCSANOW, self._old_attrs)
            self._old_attrs = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- per-frame update (TerminalInput.Update) ----------------------------

    def update(self):
        data = self._pending
        self._pending = b""
        while True:
            r, _, _ = select.select([self.fd], [], [], 0)
            if not r:
                break
            chunk = os.read(self.fd, 1024)
            if not chunk:
                break
            data += chunk
        now = time.monotonic()
        i = 0
        while i < len(data):
            ch = data[i]
            if ch == 0x1B:
                seq, used = self._parse_escape(data[i:])
                if used == 0:  # incomplete sequence: keep for next frame
                    self._pending = data[i:]
                    break
                i += used
                if seq is not None:
                    self._push_key(seq, now)
                continue
            i += 1
            if ch in (3,):  # Ctrl-C
                self._push_key("ctrl_c", now)
            elif ch in (13, 10):
                self._push_key("enter", now)
            elif ch == 9:
                self._push_key("tab", now)
            elif 32 <= ch < 127:
                self._push_key(chr(ch), now)
        # Expire held keys.
        for k in list(self._down):
            if now - self._down[k] > HOLD_S:
                del self._down[k]

    def _parse_escape(self, data: bytes) -> Tuple[Optional[str], int]:
        """Returns (key_or_None, bytes_consumed); consumed=0 if incomplete."""
        if len(data) == 1:
            return KEY_ESC, 1  # bare ESC
        # SGR mouse: \x1b[<b;x;y(M|m)
        if data[1:3] == b"[<":
            for j in range(3, min(len(data), 24)):
                if data[j] in (ord("M"), ord("m")):
                    try:
                        b_s, x_s, y_s = data[3:j].split(b";")
                        btn = int(b_s)
                        ev = MouseEvent(
                            button=btn & 3, x=int(x_s), y=int(y_s),
                            pressed=data[j] == ord("M"),
                            wheel=(1 if btn == 64 else
                                   -1 if btn == 65 else 0))
                        self._mouse.append(ev)
                    except ValueError:
                        pass
                    return None, j + 1
            return None, 0
        for pat, key in _ESC_MAP.items():
            if data[1:1 + len(pat)] == pat:
                return key, 1 + len(pat)
        # Unknown CSI: consume through its final byte.
        if data[1:2] == b"[":
            for j in range(2, min(len(data), 16)):
                if 0x40 <= data[j] <= 0x7E:
                    return None, j + 1
            return None, 0
        return None, 2  # ESC+char (alt-key): drop

    def _push_key(self, key: str, now: float):
        self._keys.append(key)
        self._down[key.lower()] = now

    # -- queries (TryGetKey / IsKeyDown / TryGetMouseEvent) -----------------

    def try_get_key(self) -> Optional[str]:
        return self._keys.popleft() if self._keys else None

    def try_get_mouse(self) -> Optional[MouseEvent]:
        return self._mouse.popleft() if self._mouse else None

    def is_key_down(self, key: str) -> bool:
        return key.lower() in self._down
