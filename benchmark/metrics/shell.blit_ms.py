"""Host ms a tick in the component's blit: ``blit_half_blocks``, the
batched path's u8 decode and the HUD text written into the framebuffer
(the port's ``component.blit`` spans), over the profiled ticks."""

LAYER = "app shell"
UNIT = "ms/tick"
MOVES = "lag_p95_ms"
SPAN = "component.blit"


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
