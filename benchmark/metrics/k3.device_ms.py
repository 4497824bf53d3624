"""Device ms a frame of K3 (``ops/cluster_kernel.py::trace_tiles``: its
init, sweep and epilogue kernels), the operations inside the "K3 cluster
sweeps" stage (``devtrace.STAGES``), over the frames of the profiled
ticks."""

LAYER = "cluster kernel K3"
UNIT = "ms/frame"
MOVES = "lag_p95_ms"
STAGE = "K3 cluster sweeps"


def read(t):
    p = t.prof
    if p is None or not p.frames or STAGE not in p.stage_ms:
        return None
    return p.stage_ms[STAGE] / p.frames
