"""Host ms inside the renderer's calls (``render_many`` and everything
beneath), over the frames they issued in the window."""

LAYER = "renderer"
UNIT = "ms/frame"
MOVES = "tick_ms"


def read(t):
    s = t.spans
    return sum(s.render_ms) / s.frames if s.frames else None
