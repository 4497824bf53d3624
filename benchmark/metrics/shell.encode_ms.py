"""Host ms a tick in the diff encode and its copy of the encoded bytes
(the port's ``present.encode`` span in ``ANSITerminalRenderer.render``),
over the profiled ticks."""

LAYER = "app shell"
UNIT = "ms/tick"
MOVES = "tick_ms"
SPAN = "present.encode"


def read(t):
    p = t.prof
    if p is None or not p.ticks:
        return None
    try:
        from yetanotherconsolegameengine_tpu_torch.utils.profiling import \
            span_ms
    except ImportError:   # a program without the tracer
        return None
    return span_ms(SPAN) / p.ticks
