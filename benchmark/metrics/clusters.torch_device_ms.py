"""Device ms a frame of the cluster sweep's torch operations: the cull,
binning sort, tile lists and resolve of ``ops/mesh_clusters.py::
intersect_clusters``, K3 left out (``devtrace.STAGES`` are innermost
first), over the frames of the profiled ticks."""

LAYER = "cluster sweep"
UNIT = "ms/frame"
MOVES = "lag_p95_ms"
STAGE = "cluster sweep host side (torch)"


def read(t):
    p = t.prof
    if p is None or not p.frames or STAGE not in p.stage_ms:
        return None
    return p.stage_ms[STAGE] / p.frames
