"""Ms a tick the shell waits for a frame's copy to the host
(``HostCopy.numpy``): the card still rendering the frame to blit."""

LAYER = "app shell"
UNIT = "ms/tick"
MOVES = "tick_ms"


def read(t):
    s = t.spans
    return s.wait_ms / len(s.tick_ms) if s.tick_ms else None
