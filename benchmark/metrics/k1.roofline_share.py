"""K1's share of its roofline: its least time a launch (the larger of
px x 2,410 fp32 operations over 67 TFLOP/s and 26 planes of 4 bytes a
pixel over 3.35 TB/s) over its device ms a launch."""

import re

from benchmark.devtrace import k1_bound_ms

LAYER = "post kernel K1"
UNIT = "%"
MOVES = "lag_p95_ms"
_NAME = re.compile(r"(?:^|::|\s)post_persistent(?:\(|$)")


def read(t):
    p = t.prof
    if p is None:
        return None
    ms = [(e - s) / 1e3 for s, e, name in p.ops if _NAME.search(name)]
    if not ms:
        return None
    return 100.0 * k1_bound_ms(p.px) / (sum(ms) / len(ms))
