"""Host ms a frame in the cluster sweep (the port's ``clusters.sweep``
span around ``ops/mesh_clusters.py::intersect_clusters``: the cull, the
K3 launch and the resolve), over the frames of the profiled ticks; None
where the span never opened."""

LAYER = "cluster sweep"
UNIT = "ms/frame"
MOVES = "lag_p95_ms"
SPAN = "clusters.sweep"


def read(t):
    p = t.prof
    if p is None or not p.frames:
        return None
    try:
        from yetanotherconsolegameengine_tpu_torch.utils.profiling import \
            SPANS
    except ImportError:   # a program without the tracer
        return None
    if SPAN not in SPANS:
        return None
    return SPANS[SPAN][1] / 1e6 / p.frames
