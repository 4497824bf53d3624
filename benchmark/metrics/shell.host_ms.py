"""Host ms a tick in the app shell: the window's ticks less the render
calls and the waits for a frame's copy to the host (blit, HUD text,
compose, diff encode, the write)."""

LAYER = "app shell"
UNIT = "ms/tick"
MOVES = "tick_ms"


def read(t):
    s = t.spans
    if not s.tick_ms:
        return None
    return (sum(s.tick_ms) - sum(s.render_ms) - s.wait_ms) / len(s.tick_ms)
