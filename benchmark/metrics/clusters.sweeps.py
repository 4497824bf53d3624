"""Cluster sweeps a frame: one for each ``intersect_clusters`` call (the
port's ``clusters.sweeps`` counter), over the frames of the profiled
ticks; None where the counter is absent."""

LAYER = "cluster sweep"
UNIT = "sweeps/frame"
MOVES = "lag_p95_ms"
COUNTER = "clusters.sweeps"


def read(t):
    p = t.prof
    if p is None or not p.frames:
        return None
    try:
        from yetanotherconsolegameengine_tpu_torch.utils.profiling import \
            COUNTS
    except ImportError:   # a program without the tracer
        return None
    if COUNTER not in COUNTS:
        return None
    return COUNTS[COUNTER] / p.frames
