"""K3's share of its roofline on the dragon: a frozen least time a frame
over K3's device ms a frame (the "K3 cluster sweeps" stage).

The least time is the larger of LANE_TESTS x 40 fp32 operations (a
lane-test: six 3-term dot products, the division, u and v, 1 - u - v)
over 67 TFLOP/s and BYTES (each input of a sweep read once, each output
written once) over 3.35 TB/s. LANE_TESTS and BYTES are frozen: those of
the frame of least K3 work among the poses the traffic can put a profiled
frame at, so that no pose reads above 100%. Nothing the program counts
is read: the yardstick stays whatever computes the sweep.

How they were taken (H100 80GB HBM3, 700 W, the program of the parent
commit): the dragon at 240x135 under the default RenderConfig, one frame
at every fourth pose of one cycle of the ``play`` traffic (1,536 ticks;
poses c % 4 == 3, so the end of every held segment), each K3 sweep's
need by the port's ``tools/profile_frame.py::k3_work`` (a ray tests
every listed entry whose key is not above its final key), summed a
frame. Frames read 0 to 591,218,688 lane-tests (median 341,559,040) and
7,723,512 to 22,686,752 bytes: where the camera has turned the dragon out
of view one sweep tests nothing. The least frame, 0 lane-tests and
7,723,512 bytes, is bound by its bytes: 0.0023055 ms. So the share reads
0.1-0.8% where the dragon is in view. (The least of the profiled frames
of three seeds' traced runs, 326,651,392 lane-tests and 18,146,512 bytes,
0.19502 ms, read 15.7-31.5%, but 65% on a view with little dragon, and
would read over 100% where it leaves the view.)"""

from benchmark.devtrace import roofline

LAYER = "cluster kernel K3"
UNIT = "%"
MOVES = "lag_p95_ms"
STAGE = "K3 cluster sweeps"
OPS_PER_LANE_TEST = 40
LANE_TESTS = 0
BYTES = 7_723_512


def read(t):
    p = t.prof
    if p is None or not p.frames or not p.stage_ms.get(STAGE):
        return None
    bound = roofline(LANE_TESTS * OPS_PER_LANE_TEST, BYTES)
    return 100.0 * bound / (p.stage_ms[STAGE] / p.frames)
