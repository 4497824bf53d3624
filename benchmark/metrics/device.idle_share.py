"""The card's idle share: 1 - busy / wall, busy the union of device
operations in the profiled ticks, wall the same number of ticks timed
with the profiler off."""

LAYER = "device"
UNIT = "%"
MOVES = "lag_p95_ms"


def read(t):
    p = t.prof
    if p is None or p.wall_off_ms <= 0:
        return None
    return 100.0 * (1.0 - p.busy_ms / p.wall_off_ms)
