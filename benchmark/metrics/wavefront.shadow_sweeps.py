"""Scene sweeps a frame of the shadow loop: one for each
``intersect_scene`` call inside ``transmittance_to_lights`` (the port's
``wavefront.shadow_sweeps`` counter), over the frames of the profiled
ticks."""

LAYER = "torch wavefront"
UNIT = "sweeps/frame"
MOVES = "tick_ms"
COUNTER = "wavefront.shadow_sweeps"


def read(t):
    p = t.prof
    if p is None or not p.frames:
        return None
    try:
        from yetanotherconsolegameengine_tpu_torch.utils.profiling import \
            COUNTS
    except ImportError:   # a program without the tracer
        return None
    return COUNTS[COUNTER] / p.frames
