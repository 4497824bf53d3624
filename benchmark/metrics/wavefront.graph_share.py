"""The share of the torch wavefront's segments that replayed a CUDA graph
over the profiled ticks: replays over replays and segments run eagerly
(the port's ``wavefront.graph_replays`` and ``wavefront.eager_segments``
counters), in %. Nothing to read for a program without the counters."""

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
    replays = COUNTS["wavefront.graph_replays"]
    runs = replays + COUNTS["wavefront.eager_segments"]
    return 100.0 * replays / runs if runs else None
