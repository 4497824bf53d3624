"""The program's app shell, driven tick by tick as a player drives it.

``Shell`` builds what ``engine/program.py --size WxH --no-world`` builds:
a ``Terminal`` on the ANSI backend with a fixed cell grid, one entity
holding a ``RaytraceComponent`` on the card's default path, and feeds it
a scripted ``ScriptedInput``. ``tick`` is the body of
``Terminal.start``: the entity update (which renders and blits), draw,
the backend's compose, diff encode and single write, and the HUD line.
It departs from ``Terminal.start`` in four ways, all fixed by the
benchmark: ``dt`` is the traffic's fixed step, not wall time; keys come
from the schedule, not from stdin, and none are read; the terminal's
output goes to ``os.devnull``; and the backend is told the console's size
(the grid and the HUD line), which a real terminal would report.

The shell records, from outside the program, when each tick starts and
ends, when each render call runs and how many frames it issues, and which
frame each blit displays (frames display in the order they were issued).
For the render calls it keeps for the comparison (every call of the
set-up and the window's first ``follow_calls``, one unbroken run from
the fresh state that the reference follows with its own state, and a
sample of the window's later calls drawn from the seed), it keeps the
frame state before and after the call, the blitted planes of each of its
frames, and the bytes the encoder wrote for each, with the screen they
were written over.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .keys import KeySchedule, ScriptedInput


@dataclasses.dataclass
class CallRecord:
    call: int
    tick: int
    n: int
    rgb: bool
    first_frame: int
    before: object            # the renderer's FrameState before the call
    after: object = None      # and after it
    blits: list = None        # per frame: (top, bot, fg, bg) as blitted
    screens: list = None      # per frame: (screen before, bytes written)

    def complete(self) -> bool:
        return all(b is not None for b in self.blits)


class Shell:
    def __init__(self, cell, seed: int, device: str = "cuda",
                 follow_calls: int = 4, sample_calls: int = 4):
        from yetanotherconsolegameengine_tpu_torch.engine.chexel import \
            Framebuffer
        from yetanotherconsolegameengine_tpu_torch.engine.entity import \
            BaseEntity
        from yetanotherconsolegameengine_tpu_torch.engine.raytrace_entity \
            import RaytraceComponent
        from yetanotherconsolegameengine_tpu_torch.engine.terminal import \
            Terminal

        cfg, tr = cell.config, cell.traffic
        self.dt = float(tr["dt"])
        self.batch = int(tr["batch"])
        self.schedule = KeySchedule(tr, seed)
        self.input = ScriptedInput(self.schedule)
        self._out = os.open(os.devnull, os.O_WRONLY)
        term = Terminal(backend="ansi", interactive=False, out_fd=self._out)
        size = (cfg["fb_w"], cfg["fb_h"] + 1)
        term.renderer.console_size = lambda: size
        term.renderer.remove_framebuffer(term.fb)
        term.fb = Framebuffer(cfg["fb_w"], cfg["fb_h"])
        term.renderer.add_framebuffer(term.fb)
        term.fixed_size = True
        entity = BaseEntity()
        self.rt = RaytraceComponent(term.fb, ss=cfg["ss"],
                                    start_scene=cfg["scene"],
                                    enable_world=False, batch=self.batch,
                                    device=device)
        entity.add_component(self.rt)
        term.add_entity(entity)
        entity.input = self.input
        term.on_resize = self.rt.resize
        self.term = term
        self._fps = 0.0

        self.tick_idx = 0
        self.setup = True    # until the window opens
        self.window = False
        self.times: List[Tuple[float, float]] = []   # every tick's span
        self.window_ticks: List[int] = []
        self.ranges = None   # record_function while profiled
        self.calls: List[Tuple[int, float, float, int]] = []
        self.issue_tick: List[int] = []    # frame id -> tick it was issued
        self.shown: List[Tuple[int, int]] = []   # (frame id, tick) in window
        self.displays = 0
        self.failed = 0
        self.errors: List[str] = []
        self._follow = follow_calls
        self._followed = 0
        self._k = sample_calls
        self._rng = np.random.default_rng(seed)
        self._window_calls = 0
        self.records: List[CallRecord] = []      # the followed run
        self.sampled: List[CallRecord] = []      # the window's sample
        self._by_frame: Dict[int, Tuple[CallRecord, int]] = {}
        self._capture: Optional[Tuple[CallRecord, int]] = None
        self._wrap()

    # -- instrumentation --------------------------------------------------

    def _wrap(self):
        r, fb, backend = self.rt.renderer, self.term.fb, self.term.renderer
        render_many, blit = r.render_many, fb.blit_half_blocks
        encode = backend._encode_native

        def timed_render_many(n, poses=None, rgb=False, times=None,
                              scene_fn=None):
            before = r.state
            t0 = time.perf_counter()
            with self.range("bench.render_call"):
                res = render_many(n, poses=poses, rgb=rgb, times=times,
                                  scene_fn=scene_fn)
            t1 = time.perf_counter()
            call, first = len(self.calls), len(self.issue_tick)
            self.calls.append((self.tick_idx, t0, t1, n))
            self.issue_tick += [self.tick_idx] * n
            rec = CallRecord(call, self.tick_idx, n, rgb, first, before,
                             r.state, [None] * n, [None] * n)
            if self.setup or (self.window
                              and self._followed < self._follow):
                self._followed += not self.setup
                self._keep(rec)
                self.records.append(rec)
            elif self.window:
                self._offer(rec)
            return res

        def shown_blit(top, bot, fg, bg):
            fid = self.displays
            self.displays += 1
            if self.window:
                self.shown.append((fid, self.tick_idx))
            hit = self._by_frame.pop(fid, None)
            if hit is not None:
                rec, k = hit
                rec.blits[k] = tuple(np.array(x, copy=True)
                                     for x in (top, bot, fg, bg))
                self._capture = hit
            with self.range("bench.blit"):
                return blit(top, bot, fg, bg)

        def captured_encode(g, f, b, origin_row):
            prev = backend._prev
            data = encode(g, f, b, origin_row)
            if self._capture is not None:
                rec, k = self._capture
                if data is None:   # no native library: the fallback's bytes
                    from yetanotherconsolegameengine_tpu_torch.engine \
                        import terminal_renderer
                    shown = terminal_renderer._py_encode(g, f, b, origin_row)
                    rec.screens[k] = (None, shown)
                else:
                    rec.screens[k] = (prev, bytes(data))
                self._capture = None
            return data

        r.render_many = timed_render_many
        fb.blit_half_blocks = shown_blit
        backend._encode_native = captured_encode

    def range(self, name: str):
        """A profiler range named ``name`` while profiled, else nothing."""
        if self.ranges is None:
            return contextlib.nullcontext()
        return self.ranges(name)

    def _keep(self, rec: CallRecord):
        for k in range(rec.n):
            self._by_frame[rec.first_frame + k] = (rec, k)

    def _drop(self, rec: CallRecord):
        for k in range(rec.n):
            self._by_frame.pop(rec.first_frame + k, None)

    def _offer(self, rec: CallRecord):
        """Reservoir sampling of the window's calls, drawn from the seed."""
        i = self._window_calls
        self._window_calls += 1
        if i < self._k:
            self.sampled.append(rec)
            self._keep(rec)
            return
        j = int(self._rng.integers(0, i + 1))
        if j < self._k:
            self._drop(self.sampled[j])
            self.sampled[j] = rec
            self._keep(rec)

    # -- the tick ---------------------------------------------------------

    def tick(self) -> None:
        """One tick of ``Terminal.start`` without reading keys."""
        term = self.term
        self.input.tick = self.tick_idx
        now = time.perf_counter()
        shown = self.displays
        try:
            term._check_resize(now)
            with self.range("bench.update"):
                for e in term.entities:
                    e.update(self.dt)
            with self.range("bench.draw"):
                for e in term.entities:
                    e.draw(term.fb)
            with self.range("bench.compose_encode_write"):
                term.renderer.render()
            ft = time.perf_counter() - now
            self._fps = 0.9 * self._fps + 0.1 * (1.0 / max(ft, 1e-6))
            hud = (f"\x1b[{term.fb.height + 1};1H\x1b[0m\x1b[K"
                   f" {self._fps:5.1f} fps | {ft * 1000.0:6.1f} ms | "
                   f"{term.renderer.name} | {term.debug_string}")
            with self.range("bench.hud_write"):
                os.write(term.out_fd, hud.encode())
            ok = self.displays > shown or self.tick_idx == 0
        except Exception as exc:   # a tick that raises is a failed tick
            ok = False
            self.errors.append(f"tick {self.tick_idx}: {exc!r}")
        end = time.perf_counter()
        self.times.append((now, end))
        if self.window:
            self.window_ticks.append(self.tick_idx)
            self.failed += not ok
        self.tick_idx += 1

    def pending(self) -> bool:
        """Has a kept call a frame not displayed yet?"""
        return any(not r.complete() for r in self.records + self.sampled)

    def close(self):
        for e in self.term.entities:
            e.close()
        os.close(self._out)

    def release(self):
        """Let the program go; the kept calls keep what they hold."""
        self.rt = self.term = None
