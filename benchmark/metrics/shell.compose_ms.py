"""Host ms a tick in the backend's compose: the framebuffer stack composed
and its planes made contiguous (the port's ``present.compose`` span in
``ANSITerminalRenderer.render``), over the profiled ticks."""

LAYER = "app shell"
UNIT = "ms/tick"
MOVES = "tick_ms"
SPAN = "present.compose"


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
