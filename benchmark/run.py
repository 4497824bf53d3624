"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with a CUDA card. Set-up
(imports, CUDA, the port's kernel library, the scene, the component and
the warm-up ticks) is timed from process start to the first timed tick;
then the shell ticks for ``--seconds``; then, with ``--trace 1``, the
per-layer metrics are read (spans from the window, then a profiler pass
over a few ticks); then the reference checks the kept render calls. The
last line of standard output is one JSON object: ``correct``,
``attempted`` (frames the window displayed), ``failed`` (ticks that
raised or displayed nothing), ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared with its limit,
which also end standard error. Exits 2 without a card, 3 if a module of
JAX or of the JAX package is loaded, 1 on any other failure, with no
result line.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "yetanotherconsolegameengine_tpu")
TRIES = 3


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its own under ``build/`` there)."""
    base = root / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def pin_to_one_core() -> int:
    """Run this process, and every thread it starts, on one CPU core: the
    highest-numbered it may use. Unpinned, the shell's host-bound ticks
    spread between runs by a third and their tails by 2x."""
    core = max(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {core})
    return core


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _merge(cell, overrides):
    for part in ("config", "traffic"):
        getattr(cell, part).update((overrides or {}).get(part, {}))
    return cell


def _percentile(values, q):
    import numpy as np
    return float(np.percentile(np.asarray(values, np.float64), q))


def end_to_end(shell, setup_s: float, names) -> dict:
    """Of ``tick_ms``, ``tick_p95_ms``, ``lag_p95_ms`` over the window and
    ``setup_s``, those in ``names`` (the cell's end-to-end metrics)."""
    first, last = shell.window_ticks[0], shell.window_ticks[-1]
    spans = [shell.times[i] for i in shell.window_ticks]
    wall = shell.times[last][1] - shell.times[first][0]
    lags = [shell.times[tick][1] - shell.times[shell.issue_tick[fid]][0]
            for fid, tick in shell.shown]
    metrics = {
        "tick_ms": {"value": wall * 1e3 / len(spans), "unit": "ms"},
        "tick_p95_ms": {"value": _percentile(
            [(e - s) * 1e3 for s, e in spans], 95), "unit": "ms"},
        "lag_p95_ms": {"value": _percentile(lags, 95) * 1e3, "unit": "ms"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }
    return {k: v for k, v in metrics.items() if k in names}


def window_spans(shell, waits) -> SimpleNamespace:
    """Host time in the window: its wall, ticks, render calls, copy
    waits."""
    ticks = set(shell.window_ticks)
    first, last = shell.window_ticks[0], shell.window_ticks[-1]
    wall_ms = (shell.times[last][1] - shell.times[first][0]) * 1e3
    tick_ms = [(e - s) * 1e3 for i, (s, e) in enumerate(shell.times)
               if i in ticks]
    calls = [(t1 - t0) * 1e3 for tick, t0, t1, _ in shell.calls
             if tick in ticks]
    frames = sum(n for tick, _, _, n in shell.calls if tick in ticks)
    wait_ms = sum(w for tick, w in waits if tick in ticks) * 1e3
    return SimpleNamespace(wall_ms=wall_ms, tick_ms=tick_ms, render_ms=calls,
                           frames=frames, wait_ms=wait_ms)


def profile_ticks(shell, cell, device) -> SimpleNamespace:
    """A profiler pass over a few steady ticks, after the same number of
    ticks with the profiler off (the wall that the idle share is taken
    against). Lost kernel records are profiled again, a synchronise a
    tick, up to ``TRIES`` passes; None if every pass lost some."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from yetanotherconsolegameengine_tpu_torch.ops import kernels

    from . import devtrace
    batch = shell.batch
    m = -(-int(cell.config["profile_ticks"]) // batch) * batch
    frames_at = lambda: len(shell.issue_tick)
    torch.cuda.synchronize(device)
    f0, t0 = frames_at(), time.perf_counter()
    for _ in range(m):
        shell.tick()
    torch.cuda.synchronize(device)
    wall_off = (time.perf_counter() - t0) * 1e3
    frames_off = frames_at() - f0
    undo = devtrace.patch_stages(record_function)
    shell.ranges = record_function
    try:
        for attempt in range(TRIES):
            kernels.reset_launches()
            f0 = frames_at()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                for _ in range(m):
                    shell.tick()
                    if attempt:
                        torch.cuda.synchronize(device)
                torch.cuda.synchronize(device)
                wall_on = (time.perf_counter() - t0) * 1e3
            frames = frames_at() - f0
            events = prof.events()
            ops, spans = devtrace.device_ops(events)
            records = devtrace.kernel_records(o[2] for o in ops)
            lost = devtrace.lost_records(dict(kernels.LAUNCHES), records)
            if not lost:
                break
    finally:
        shell.ranges = None
        undo()
    if lost:
        print(f"profiler lost kernel records in {TRIES} passes: {lost}",
              file=sys.stderr)
        return None
    labels = {label for _, label in devtrace.STAGES} | {
        "bench.update", "bench.render_call", "bench.blit", "bench.draw",
        "bench.compose_encode_write", "bench.hud_write", "bench.copy_wait"}
    px = cell.config["fb_w"] * cell.config["ss"] * 2 * cell.config["fb_h"] \
        * cell.config["ss"]
    return SimpleNamespace(
        ops=ops, stage_ms=devtrace.busy_by_stage(ops, spans),
        host=devtrace.host_ranges(events, labels), frames=frames,
        frames_off=frames_off, ticks=m, wall_off_ms=wall_off,
        wall_on_ms=wall_on, busy_ms=devtrace.union_ms(o[:2] for o in ops),
        px=px)


def breakdown(prof) -> dict:
    """The device operations that took most time, and the longest idle
    gaps between device operations, each named by the innermost host
    range open at its middle."""
    import collections
    per_op = collections.Counter()
    for s, e, name in prof.ops:
        per_op[name[:120]] += (e - s) / 1e6
    merged = []
    for s, e, _ in sorted(prof.ops):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = []
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        open_ = [(e - s, name) for s, e, name in prof.host if s <= mid <= e]
        gaps.append([min(open_)[1] if open_ else "no host range",
                     (b - a) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[k, v] for k, v in per_op.most_common(10)],
            "idle_gaps": gaps[:10]}


def run_cell(workload: str, seed: int, seconds: float, trace: int,
             device: str = "cuda", root: Path = ROOT, overrides=None,
             control: bool = False):
    """Run one cell once; returns (result dict, [(number, value, limit)],
    the errors of failed ticks).
    ``overrides`` ({"config": {...}, "traffic": {...}}) shrink a cell for
    the CPU tests; ``control`` also returns the lower-precision control's
    numbers under the key "control"."""
    import torch

    from . import check, spec
    from .shell import Shell

    cell = _merge(spec.load_cell(root, workload), overrides)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    tr = cell.traffic
    shell = Shell(cell, seed, device, follow_calls=int(tr["follow_calls"]),
                  sample_calls=int(tr["check_calls"]))
    for _ in range(max(int(cell.config["warmup_ticks"]),
                       2 * shell.batch + 2)):
        shell.tick()
    if shell.errors:
        raise RuntimeError(f"set-up ticks failed: {shell.errors}")
    waits = []
    if trace:
        from yetanotherconsolegameengine_tpu_torch.engine import \
            raytrace_entity
        real_numpy = raytrace_entity.HostCopy.numpy

        def waited_numpy(hc):
            t0 = time.perf_counter()
            with shell.range("bench.copy_wait"):
                out = real_numpy(hc)
            waits.append((shell.tick_idx, time.perf_counter() - t0))
            return out
        raytrace_entity.HostCopy.numpy = waited_numpy
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - _T0
    try:
        shell.setup, shell.window = False, True
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            shell.tick()
        shell.window = False
        for _ in range(4 * shell.batch + 4):   # frames still to display
            if not shell.pending():
                break
            shell.tick()
        if cuda:
            torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        result = {"correct": False, "attempted": len(shell.shown),
                  "failed": shell.failed}
        if trace:
            span = window_spans(shell, waits)
            prof = profile_ticks(shell, cell, dev) if cuda else None
            inputs = SimpleNamespace(spans=span, prof=prof, cell=cell)
            metrics = {}
            for m in cell.per_layer:
                value = spec.metric_reader(m["name"]).read(inputs)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            result["metrics"] = metrics
        else:
            result["metrics"] = end_to_end(
                shell, setup_s, {m["name"] for m in cell.end_to_end})
    finally:
        if trace:
            raytrace_entity.HostCopy.numpy = real_numpy
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    if trace and prof is not None:
        result["device"]["busy_s"] = prof.busy_ms / 1e3
        result["device"]["window_s"] = prof.wall_on_ms / 1e3
        result["breakdown"] = breakdown(prof)

    # The comparison: the program's state is let go first, but for what
    # the kept calls hold.
    t_check = time.perf_counter()
    inputs = check.scene_inputs(cell)
    numbers = {"input_diff": check.input_diff(shell.rt.renderer, cell,
                                              inputs)}
    shell.close()
    shell.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers.update(check.compare(shell, cell, dev, inputs=inputs))
    t_end = time.perf_counter()
    print(f"timing: set-up {setup_s:.1f} s, window {seconds:.1f} s, "
          f"reference {t_end - t_ref:.1f} s for "
          f"{numbers['frames_checked']} frames, check {t_end - t_check:.1f}"
          " s", file=sys.stderr)
    lines = [(k, numbers[k], cell.limits[k]) for k in check.NUMBERS]
    result["correct"] = (all(v <= lim for _, v, lim in lines)
                         and not shell.errors and shell.failed == 0)
    if control:
        result["control"] = check.compare(shell, cell, dev, control=True,
                                          inputs=inputs)
    result["check"] = {k: {"value": v, "limit": lim} for k, v, lim in lines}
    return result, lines, shell.errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    core = pin_to_one_core()
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("benchmark: no CUDA card", file=sys.stderr)
        return 2
    from .devtrace import card_line
    print(f"card: {card_line()}; pinned to CPU core {core}", file=sys.stderr)
    try:
        result, lines, errors = run_cell(args.workload, args.seed,
                                         args.seconds, args.trace)
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for e in errors[:5]:
        print(f"error: {e}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    for name, value, limit in lines:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
