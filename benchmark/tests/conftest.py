"""Shared set-up of the benchmark's tests: a tiny cell on the CPU."""

import pytest

# A cell cut to a 24x8 cell grid (24x16 traced pixels) with few warm-up
# and kept calls, so that a run fits a CPU test.
TINY = {"config": {"fb_w": 24, "fb_h": 8, "warmup_ticks": 2,
                   "profile_ticks": 4},
        "traffic": {"follow_calls": 1, "check_calls": 1}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
    config.addinivalue_line(
        "markers", "slow: builds the 598,520-triangle dragon twice")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
