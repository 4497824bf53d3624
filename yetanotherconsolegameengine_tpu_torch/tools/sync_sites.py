"""The port's spans, counters and host waits over a few ticks of the
terminal program, and the host call behind each copy of the trace.

    python3 -m yetanotherconsolegameengine_tpu_torch.tools.sync_sites \
        [--scene cornell] [--size 160x90] [--batch 1] [--warmup 20]
        [--ticks 48] [--device cuda]

Builds what ``engine/program.py --size WxH --no-world --non-interactive``
builds, its frames written to ``os.devnull`` and no keys read, runs
``--warmup`` ticks of ``Terminal.tick`` at dt = 1/30 s, then ``--ticks``
more under ``torch.profiler`` after ``kernels.reset_launches()`` (which
clears the tracer's registry, ``utils/profiling.py``), and prints:

- each span's calls, inclusive and self ms, a tick;
- the counters and the kernel wrappers' launches, a frame;
- each ``sync`` site's host waits and the ms they blocked, a frame;
- every copy and memset record of the trace, by its kind, the ``sync``
  site (or else the innermost span) its host call ran in, and that host
  operation, a frame; records whose host call the profiler did not link
  are counted apart.

Writes the lines to ``chiprun_out/sync_sites_<scene>_b<batch>.txt`` under
the working directory as well.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time

import torch

from ..utils import profiling

OUT = "chiprun_out"
COPY_KINDS = ("Memcpy", "Memset")


def copy_sites(events) -> collections.Counter:
    """{(kind, site, host operation): [records, device us]} of the copy and
    memset records in ``events`` (``prof.events()``). The site is the
    innermost ``sync.<site>`` range or, without one, the innermost span of
    ``profiling.SPAN_NAMES`` around the host operation that launched the
    record; records with no linked host operation are under ("unlinked")."""
    from torch.autograd import DeviceType
    out = collections.defaultdict(lambda: [0, 0.0])
    linked = 0
    for ev in events:
        if ev.device_type == DeviceType.CUDA:
            continue
        for k in getattr(ev, "kernels", ()):
            if not k.name.startswith(COPY_KINDS):
                continue
            linked += 1
            site = span = None
            op = ev.name
            p = ev.cpu_parent
            while p is not None and site is None:
                if p.name.startswith(profiling.SYNC_PREFIX):
                    site = p.name
                elif p.name in profiling.SPAN_NAMES:
                    span = span or p.name
                elif span is None:
                    op = p.name   # the outermost operation inside the span
                p = p.cpu_parent
            rec = out[(k.name, site or span or "no span", op)]
            rec[0] += 1
            rec[1] += k.duration
    records = [ev for ev in events if ev.device_type == DeviceType.CUDA
               and ev.name.startswith(COPY_KINDS)]
    if len(records) > linked:
        rec = out[("(any)", "unlinked", "")]
        rec[0] += len(records) - linked
    return out


def build(scene: str, w: int, h: int, batch: int, device: str):
    from ..engine.chexel import Framebuffer
    from ..engine.entity import BaseEntity
    from ..engine.raytrace_entity import RaytraceComponent
    from ..engine.terminal import Terminal
    out_fd = os.open(os.devnull, os.O_WRONLY)
    term = Terminal(backend="ansi", interactive=False, out_fd=out_fd)
    term.renderer.console_size = lambda: (w, h + 1)
    term.renderer.remove_framebuffer(term.fb)
    term.fb = Framebuffer(w, h)
    term.renderer.add_framebuffer(term.fb)
    term.fixed_size = True
    entity = BaseEntity()
    rt = RaytraceComponent(term.fb, start_scene=scene, enable_world=False,
                           batch=batch, device=device)
    entity.add_component(rt)
    term.add_entity(entity)
    return term, rt, out_fd


def run(scene: str, w: int, h: int, batch: int, warmup: int, ticks: int,
        device: str) -> list:
    """The report's lines (see the module's docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from ..ops import kernels
    term, rt, out_fd = build(scene, w, h, batch, device)
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize()) if cuda else (lambda: None)
    dt = 1.0 / 30.0
    try:
        for _ in range(warmup):
            term.tick(time.perf_counter(), dt)
        sync()
        kernels.reset_launches()
        f0 = rt.renderer.state.frame_idx
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with profile(activities=acts) as prof:
            for _ in range(ticks):
                term.tick(time.perf_counter(), dt)
            sync()
        frames = max(1, rt.renderer.state.frame_idx - f0)
        events = prof.events()
    finally:
        for e in term.entities:
            e.close()
        os.close(out_fd)
    lines = [f"{scene} {w}x{h} batch {batch} on {device}: {ticks} ticks, "
             f"{frames} frames profiled"]
    lines.append("spans (calls, inclusive ms, self ms a tick):")
    for name, (n, ns, self_ns) in sorted(profiling.SPANS.items()):
        lines.append(f"  {name:18s} {n / ticks:7.3f} {ns / 1e6 / ticks:9.4f}"
                     f" {self_ns / 1e6 / ticks:9.4f}")
    counts = {**profiling.COUNTS, **{f"launches.{k}": v for k, v in
                                     kernels.LAUNCHES.items() if v}}
    lines.append("counters a frame: " + ", ".join(
        f"{k} {v / frames:.3f}" for k, v in sorted(counts.items())))
    lines.append("sync sites (waits, blocked ms a frame):")
    for site, n in sorted(profiling.SYNCS.items()):
        lines.append(f"  {site:26s} {n / frames:8.3f} "
                     f"{profiling.SYNC_NS[site] / 1e6 / frames:9.4f}")
    lines.append(f"  {'all':26s} {sum(profiling.SYNCS.values()) / frames:8.3f}"
                 f" {sum(profiling.SYNC_NS.values()) / 1e6 / frames:9.4f}")
    lines.append("copy and memset records (a frame, device us a frame; "
                 "kind, site, host operation):")
    for (kind, site, op), (n, us) in sorted(copy_sites(events).items()):
        lines.append(f"  {n / frames:7.3f} {us / frames:9.2f}  {kind} | "
                     f"{site} | {op}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--size", default="160x90")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ticks", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.lower().split("x"))
    lines = run(args.scene, w, h, args.batch, args.warmup, args.ticks,
                args.device)
    text = "\n".join(lines) + "\n"
    sys.stdout.write(text)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(
            OUT, f"sync_sites_{args.scene}_b{args.batch}.txt"), "w") as f:
        f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
