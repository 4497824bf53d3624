"""Device ms a frame of the BVH walk kernel's records
(``bvh_walk_kernel``)."""

import re

LAYER = "BVH walk kernel"
UNIT = "ms/frame"
MOVES = "tick_ms"
_NAME = re.compile(r"(?:^|::|\s)bvh_walk_kernel(?:\(|$)")


def read(t):
    p = t.prof
    if p is None or not p.frames:
        return None
    ms = [(e - s) / 1e3 for s, e, name in p.ops if _NAME.search(name)]
    return sum(ms) / p.frames if ms else None
