"""K2's share of its roofline: its least time a launch by bytes (the
scene's packed table read once, 12 planes written once) over its device
ms a launch."""

import re

from benchmark.check import scene_inputs
from benchmark.devtrace import k2_bound_ms

LAYER = "trace kernel K2"
UNIT = "%"
MOVES = "lag_p95_ms"
_NAME = re.compile(r"(?:^|::|\s)trace_kernel(?:\(|$)")


def read(t):
    p = t.prof
    if p is None:
        return None
    ms = [(e - s) / 1e3 for s, e, name in p.ops if _NAME.search(name)]
    if not ms:
        return None
    return 100.0 * k2_bound_ms(p.px, scene_inputs(t.cell)) / (sum(ms)
                                                              / len(ms))
