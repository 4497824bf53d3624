"""Tracing & frame telemetry.

Port of ``yetanotherconsolegameengine_tpu/utils/profiling.py``:
``device_trace`` records a ``torch.profiler`` trace (host operations, and
the card's kernels and copies when there is a card) and writes it as a
Chrome trace into ``log_dir``; ``timed`` times one call by CUDA events and
the host clock over the same window; ``card_line`` names the card and its
power limit for a measurement's record; ``FrameStats`` (copied) is the
rolling frame-time aggregator behind the HUD line.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import tempfile
import time
from collections import deque
from typing import Deque, Dict, Optional

import torch


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Record a torch.profiler trace of the block and write it to
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing).

    Usage: ``with device_trace(dir): render frames``; or wire through
    ``program.py --profile DIR``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "yacge_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (the
    device's name where it is absent); "cpu" for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(dev)


def timed(fn, n: int, device):
    """Call ``fn()`` once between two synchronisations of ``device``.
    Returns (ms per unit of the ``n`` units of work it does, by CUDA events
    on a CUDA device and by the host clock elsewhere; ms per unit by the
    host clock; what ``fn`` returned)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    sync()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    if cuda:
        start.record()
    res = fn()
    if cuda:
        stop.record()
    sync()
    host = (time.perf_counter() - t0) * 1e3 / n
    return (start.elapsed_time(stop) / n if cuda else host), host, res


class FrameStats:
    """Rolling frame statistics for the HUD (Terminal.cs:163-175 role)."""

    def __init__(self, window: int = 120):
        self._times: Deque[float] = deque(maxlen=window)
        self._marks: Dict[str, float] = {}
        self._stage_ms: Dict[str, Deque[float]] = {}
        self._t0: Optional[float] = None

    def begin_frame(self):
        self._t0 = time.perf_counter()

    def end_frame(self):
        if self._t0 is not None:
            self._times.append(time.perf_counter() - self._t0)
            self._t0 = None

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a named stage within the frame."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            d = self._stage_ms.setdefault(name, deque(maxlen=60))
            d.append((time.perf_counter() - t0) * 1000.0)

    @property
    def fps(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / max(1e-9, sum(self._times))

    @property
    def frame_ms(self) -> float:
        if not self._times:
            return 0.0
        return 1000.0 * sum(self._times) / len(self._times)

    def p99_ms(self) -> float:
        if not self._times:
            return 0.0
        s = sorted(self._times)
        return 1000.0 * s[min(len(s) - 1, int(0.99 * len(s)))]

    def summary(self) -> str:
        parts = [f"{self.fps:5.1f} fps {self.frame_ms:6.2f} ms "
                 f"(p99 {self.p99_ms():.2f})"]
        for name, d in self._stage_ms.items():
            parts.append(f"{name} {sum(d) / len(d):.2f}ms")
        return " | ".join(parts)
