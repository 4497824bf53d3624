"""The 95th percentile of the window's ticks, read from the ``--trace 1``
run's window (profiler off): ``tick_p95_ms`` as a per-layer metric, for
cells whose runs spread too widely for it to stand end to end."""

import numpy as np

LAYER = "app shell"
UNIT = "ms"
MOVES = "lag_p95_ms"


def read(t):
    s = t.spans
    if not s.tick_ms:
        return None
    return float(np.percentile(np.asarray(s.tick_ms, np.float64), 95))
