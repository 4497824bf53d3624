"""Host waits for the card a frame: every ``sync`` site of the port (reads
of a device value, blocking copies to the card, the frame copy's event
wait), over the frames of the profiled ticks."""

LAYER = "device"
UNIT = "syncs/frame"
MOVES = "lag_p95_ms"


def read(t):
    p = t.prof
    if p is None or not p.frames:
        return None
    try:
        from yetanotherconsolegameengine_tpu_torch.utils.profiling import \
            SYNCS
    except ImportError:   # a program without the tracer
        return None
    return sum(SYNCS.values()) / p.frames
