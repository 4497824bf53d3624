"""Device ms a frame inside the coloured-transmittance shadow loop
(``ops/trace.py::transmittance_to_lights``), less the stages it encloses
(the BVH walk kernel's sweeps count as the walk's)."""

LAYER = "torch wavefront"
UNIT = "ms/frame"
MOVES = "tick_ms"


def read(t):
    p = t.prof
    if p is None or not p.frames:
        return None
    ms = p.stage_ms.get("shadow loop (torch)")
    return None if ms is None else ms / p.frames
