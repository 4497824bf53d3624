"""Host ms a frame in the trace: K2's wrapper or the torch wavefront
(``trace_wavefront_planes``; the port's ``frame.trace`` span in
``frame_step``), over the frames of the profiled ticks."""

LAYER = "renderer"
UNIT = "ms/frame"
MOVES = "lag_p95_ms"
SPAN = "frame.trace"


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
