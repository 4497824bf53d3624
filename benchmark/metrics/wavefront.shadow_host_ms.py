"""Host ms a frame in the coloured-transmittance shadow loop
(``ops/trace.py::transmittance_to_lights``, the port's
``wavefront.shadow`` span), its sweeps and host checks included, over
the frames of the profiled ticks."""

LAYER = "torch wavefront"
UNIT = "ms/frame"
MOVES = "tick_ms"
SPAN = "wavefront.shadow"


def read(t):
    p = t.prof
    if p is None or not p.frames:
        return None
    try:
        from yetanotherconsolegameengine_tpu_torch.utils.profiling import \
            span_ms
    except ImportError:   # a program without the tracer
        return None
    return span_ms(SPAN) / p.frames
