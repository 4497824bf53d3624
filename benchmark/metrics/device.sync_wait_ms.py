"""Host ms a frame blocked at the port's ``sync`` sites, over the frames of
the profiled ticks."""

LAYER = "device"
UNIT = "ms/frame"
MOVES = "tick_ms"


def read(t):
    p = t.prof
    if p is None or not p.frames:
        return None
    try:
        from yetanotherconsolegameengine_tpu_torch.utils.profiling import \
            SYNC_NS
    except ImportError:   # a program without the tracer
        return None
    return sum(SYNC_NS.values()) / 1e6 / p.frames
