"""The share of the scene sweeps over the profiled ticks whose primitive
tables went through the primitive kernel: the port's
``wavefront.prim_kernel_sweeps`` counter over it and
``wavefront.prim_plain_sweeps``, in %. Nothing to read for a program
without the counters."""

LAYER = "torch wavefront"
UNIT = "%"
MOVES = "tick_ms"


def read(t):
    p = t.prof
    if p is None or not p.frames:
        return None
    try:
        from yetanotherconsolegameengine_tpu_torch.utils.profiling import \
            COUNTS
    except ImportError:   # a program without the tracer
        return None
    kernel = COUNTS["wavefront.prim_kernel_sweeps"]
    sweeps = kernel + COUNTS["wavefront.prim_plain_sweeps"]
    return 100.0 * kernel / sweeps if sweeps else None
