"""Device kernels, copies and memsets in the profiled ticks, a frame."""

LAYER = "device"
UNIT = "kernels/frame"
MOVES = "tick_ms"


def read(t):
    p = t.prof
    return len(p.ops) / p.frames if p is not None and p.frames else None
