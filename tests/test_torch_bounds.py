"""The least-time model behind every bound and roofline share that
``chip_smoke.py`` prints (PERF.md § 6's bound column), on hand counts: the
larger of operations over 67 TFLOP/s and bytes over 3.35 TB/s, named, and
the walk's, the DDA's and K3's operations and bytes as that table states
them. Each kernel is held at one count bound by operations and one bound
by bytes, so both terms of its formula are checked."""

import pytest
import torch

from chip_smoke import dda_bound, k3_work, roofline, walk_bound


def _walk(visits, tri_tests, rows, rays):
    return (lambda: walk_bound({"visits": visits, "tri_tests": tri_tests,
                                "rows": rows}, rays),
            visits * 25 + tri_tests * 57, rays * 61 + rows * 240)


def _dda(rounds, cells, rays):
    return (lambda: dda_bound({"rounds": rounds, "cells": cells}, rays),
            rounds * 52, rays * 57 + cells * 2)


def _k3(kc):
    """One tile of 256 rays, a list of 2 clusters of ``kc`` triangles
    entered at t = 1 and 3; rays 0-127 hit at t = 2, the rest miss under a
    tinit of 5. A hit needs the first entry only, a miss both: kc * (128 +
    256) lane-tests. Bytes: lens 4, ids 8, entry_t 8, gmat 2 * 12 * kc * 4,
    rays 256 * 32 in; 8 a ray and 4 a tile out."""
    def bound():
        rays = torch.zeros(256, 8)
        rays[:, 7] = 5.0
        args = (torch.tensor([2], dtype=torch.int32),
                torch.tensor([[1, 0]], dtype=torch.int32),
                torch.tensor([[1.0, 3.0]]), torch.zeros(2, 12, kc), rays,
                False, 0)
        win = torch.full((256,), -1, dtype=torch.int32)
        win[:128] = 0
        t = torch.where(win >= 0, 2.0, float("inf"))
        work = k3_work(args, (t, win, torch.tensor([2], dtype=torch.int32)))
        assert work["lane_tests"] == kc * (128 + 256)
        return work["bound_ms"], work["bound_by"]
    return (bound, kc * (128 + 256) * 40,
            4 + 8 + 8 + 2 * 12 * kc * 4 + 256 * 32 + 256 * 8 + 4)


# kernel: [(its bound on hand counts, operations, bytes)]
CASES = {
    "walk": [_walk(10**9, 3 * 10**8, 5 * 10**5, 2 * 10**6),
             _walk(10**6, 10**5, 10**6, 2 * 10**6)],
    "dda": [_dda(4 * 10**7, 10**5, 28800), _dda(4 * 10**5, 3 * 10**5, 28800)],
    "k3": [_k3(64), _k3(4)],
}


@pytest.mark.parametrize("kernel", sorted(CASES))
def test_bounds_follow_the_least_time_model(kernel):
    by = set()
    for bound, ops, nbytes in CASES[kernel]:
        t_ops, t_bytes = ops / 67e12 * 1e3, nbytes / 3.35e12 * 1e3
        want = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
                else "bytes")
        assert roofline(ops, nbytes) == want
        assert bound() == want
        by.add(want[1])
    assert by == {"operations", "bytes"}
