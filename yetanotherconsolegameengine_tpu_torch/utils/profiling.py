"""Tracing: the port's spans and counters, and device traces.

Port of ``yetanotherconsolegameengine_tpu/utils/profiling.py``, with the
port's one tracer and its registry of totals:

- ``span(name)`` times a stage of the program. With no ``torch.profiler``
  recording it costs one flag check and returns a shared no-op context.
  While one records, it opens a range of that name in the profiler's
  function scope (as an operator's, not a ``record_function`` user
  range), so the stage lies on the trace's clock beside the kernels it
  launched, and adds to ``SPANS[name]``: [calls, inclusive ns, self ns].
  A device trace annotates a kernel with the innermost user range open at
  its launch only: a span, never one, leaves every kernel inside it to a
  stage range that a tool wraps around the function that opens the span
  (``benchmark/devtrace.py::patch_stages``). Self is the duration less
  that of the spans opened inside it. No list of spans is kept: the
  timeline is the profiler's trace (``device_trace``, ``program.py
  --profile DIR``). Spans are opened on one thread.
- ``count(name, n)`` adds to ``COUNTS``, whether a profiler records or not.
- ``sync(site, fn, *args)`` returns ``fn(*args)``, a call at which the
  host waits for the device: a read of a device value, a blocking copy
  of a host array to the device, an event wait. It always counts the
  site in ``SYNCS``; while a profiler records, it also opens the range
  ``sync.<site>`` and adds the ns the call blocked to ``SYNC_NS``.
  ``waited(site, ns)`` counts a wait known only after the call.
- ``register(name, table)`` adds another module's counters to the
  registry (``kernels.LAUNCHES``, ``mesh_bvh.STATS``, ``dda.STATS``,
  which stay the same objects); ``reset()`` clears the whole registry
  (``kernels.reset_launches()`` calls it). ``totals`` and ``add_totals``
  read and add to its counts: a CUDA graph's replay adds what its capture
  counted (``ops/trace.py``).

``device_trace`` records a ``torch.profiler`` trace (host operations, and
the card's kernels and copies when there is a card) and writes it as a
Chrome trace; ``timed`` times one call by CUDA events and the host clock
over the same window; ``card_line`` names the card and its power limit
for a measurement's record.
"""

from __future__ import annotations

import collections
import contextlib
import os
import subprocess
import tempfile
import time
from typing import Dict, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

# The registry. Spans and the ns of syncs fill only while a profiler
# records; counts and sync sites always count.
SPANS: Dict[str, List[int]] = {}          # name -> [calls, ns, self ns]
COUNTS = collections.Counter()            # count(): name -> n
SYNCS = collections.Counter()             # sync(): site -> host waits
SYNC_NS = collections.Counter()           # sync(): site -> ns blocked
TABLES: Dict[str, dict] = {}              # register(): name -> counters

# Every span the port opens (a sync's range is "sync.<site>").
SPAN_NAMES = ("tick", "tick.input", "tick.hud", "component.update",
              "component.blit", "render.call", "render.prep", "frame.trace",
              "frame.post", "wavefront.shadow", "clusters.sweep",
              "clusters.cull", "clusters.resolve", "present.compose",
              "present.encode", "present.write")
SYNC_PREFIX = "sync."

_open: List["_Span"] = []                 # the spans open, innermost last


_OFF = contextlib.nullcontext()          # every span while none records


class _Span:
    __slots__ = ("name", "child_ns", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._range = _RecordFunctionFast(name)

    def __enter__(self):
        self._range.__enter__()
        self.child_ns = 0
        _open.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        _open.pop()
        if _open:
            _open[-1].child_ns += ns
        tot = SPANS.get(self.name)
        if tot is None:
            tot = SPANS[self.name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += ns
        tot[2] += ns - self.child_ns
        return self._range.__exit__(*exc)


def span(name: str):
    """A context that times the stage ``name`` while a profiler records,
    and does nothing otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    COUNTS[name] += n


def sync(site: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a call at which the host waits for the
    device, counted under ``site`` (and timed while a profiler records)."""
    SYNCS[site] += 1
    if not _autograd_profiler._is_profiler_enabled:
        return fn(*args, **kwargs)
    with _autograd_profiler.record_function(SYNC_PREFIX + site):
        t0 = time.perf_counter_ns()
        out = fn(*args, **kwargs)
        SYNC_NS[site] += time.perf_counter_ns() - t0
    return out


def waited(site: str, ns: int) -> None:
    """Count a host wait found after the call that made it (``ns`` long),
    as ``sync`` counts one it wraps."""
    SYNCS[site] += 1
    if _autograd_profiler._is_profiler_enabled:
        SYNC_NS[site] += ns


def register(name: str, table: dict) -> dict:
    """Put ``table`` (a dict of counts) in the registry; returns it."""
    TABLES[name] = table
    return table


def reset() -> None:
    """Clear every total of the registry: spans, counts, sync sites, and
    the registered tables (a Counter emptied, a dict's counts zeroed)."""
    SPANS.clear()
    COUNTS.clear()
    SYNCS.clear()
    SYNC_NS.clear()
    for table in TABLES.values():
        if isinstance(table, collections.Counter):
            table.clear()
        else:
            for k in table:
                table[k] = 0


def totals() -> dict:
    """Every count of the registry: ``COUNTS`` under (None, name), each
    registered table's under (its name, key)."""
    out = {(None, k): n for k, n in COUNTS.items()}
    for name, table in TABLES.items():
        out.update(((name, k), n) for k, n in table.items())
    return out


def add_totals(delta: dict, sign: int = 1) -> None:
    """Add ``delta``, keyed as ``totals`` keys it, times ``sign`` to the
    registry's counts."""
    for (name, k), n in delta.items():
        table = COUNTS if name is None else TABLES[name]
        table[k] = table.get(k, 0) + sign * n


def span_ms(name: str) -> float:
    """Inclusive ms of the span ``name`` since the last reset."""
    return SPANS.get(name, (0, 0, 0))[1] / 1e6


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Record a torch.profiler trace of the block and write it to
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing); with
    no ``log_dir``, into a new temporary directory. Yields the directory.

    Usage: ``with device_trace(dir): render frames``; or wire through
    ``program.py --profile DIR``."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="yacge_trace_")
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
