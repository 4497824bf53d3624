"""The share of the cluster sweeps over the profiled ticks whose cull and
resolve went through the kernels: the port's ``clusters.kernel_sweeps``
counter over it and ``clusters.plain_sweeps``, in %. Nothing to read for
a program without the counters."""

LAYER = "cluster sweep"
UNIT = "%"
MOVES = "lag_p95_ms"


def read(t):
    p = t.prof
    if p is None or not p.frames:
        return None
    try:
        from yetanotherconsolegameengine_tpu_torch.utils.profiling import \
            COUNTS
    except ImportError:   # a program without the tracer
        return None
    kernel = COUNTS["clusters.kernel_sweeps"]
    sweeps = kernel + COUNTS["clusters.plain_sweeps"]
    return 100.0 * kernel / sweeps if sweeps else None
