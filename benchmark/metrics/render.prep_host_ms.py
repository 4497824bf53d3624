"""Host ms a frame preparing the render call: video textures, the pose
upload (``stack_poses``), ``frame_inputs`` and the output grids (the
port's ``render.prep`` spans in ``render_many`` and ``frame_scan``), over
the frames of the profiled ticks."""

LAYER = "renderer"
UNIT = "ms/frame"
MOVES = "lag_p95_ms"
SPAN = "render.prep"


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
