"""Host ms a frame after the trace: the post path (K1's wrapper), the
output planes and the frame's grid writes (the port's ``frame.post``
spans in ``frame_step`` and ``frame_scan``), over the frames of the
profiled ticks."""

LAYER = "renderer"
UNIT = "ms/frame"
MOVES = "tick_ms"
SPAN = "frame.post"


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
