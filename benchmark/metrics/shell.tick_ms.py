"""The window's wall time over the ticks it completed, read from the
``--trace 1`` run's window (profiler off): ``tick_ms`` as a per-layer
metric, for cells whose runs spread too widely for it to stand end to
end (``cornell.batch8``: the host's speed drifts between runs)."""

LAYER = "app shell"
UNIT = "ms"
MOVES = "lag_p95_ms"


def read(t):
    s = t.spans
    return s.wall_ms / len(s.tick_ms) if s.tick_ms else None
