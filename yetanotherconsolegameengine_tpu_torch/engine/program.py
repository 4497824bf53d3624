"""Application entry point.

Port of ``yetanotherconsolegameengine_tpu/engine/program.py``, the
counterpart of Program.cs (Program.cs:5-33), with an argparse surface
replacing the single positional supersample arg:

    python -m yetanotherconsolegameengine_tpu_torch.engine.program \\
        [--scene cornell] [--ss 2] [--backend ansi] [--frames N] \\
        [--size WxH] [--no-world] [--mouse] [--batch K] [--device cpu]

It renders on the card unless ``--device cpu`` is given.

Keys: WASD+QE move, arrows look, Shift boost, I/U cycle scenes, Y orbit,
[ ] cycle backends, F fly toggle (voxel world), P PNG screenshot, H HUD
toggle, V video mode, Esc/Ctrl-C quit.
"""

from __future__ import annotations

import argparse
import sys

from .entity import BaseEntity
from .raytrace_entity import RaytraceComponent, default_scene_order
from .terminal import Terminal


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Terminal ray tracer "
                                             "(PyTorch/CUDA)")
    ap.add_argument("--scene", default="cornell",
                    help=f"start scene ({', '.join(default_scene_order())})")
    ap.add_argument("--ss", type=int, default=1,
                    help="supersample factor (Program.cs args[0])")
    ap.add_argument("--backend", default="ansi",
                    choices=("ansi", "plain", "window"))
    ap.add_argument("--frames", type=int, default=None,
                    help="exit after N frames (benchmark/CI mode)")
    ap.add_argument("--size", default=None,
                    help="fixed WxH cell grid (default: terminal size)")
    ap.add_argument("--fps", type=float, default=None, help="fps cap")
    ap.add_argument("--no-world", action="store_true",
                    help="skip the streamed voxel world scene")
    ap.add_argument("--mouse", action="store_true",
                    help="enable SGR mouse capture")
    ap.add_argument("--non-interactive", action="store_true",
                    help="no raw mode / alt screen (pipes, CI)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler trace (trace.json) to DIR")
    ap.add_argument("--batch", type=int, default=1,
                    help="frames per render_many call (K>1 amortizes the "
                         "per-frame host round trip K-fold at ~K-2K ticks "
                         "of input latency)")
    ap.add_argument("--device", default="cuda",
                    help="render device: cuda (default; needs a card) or "
                         "cpu")
    args = ap.parse_args(argv)

    term = Terminal(backend=args.backend, enable_mouse=args.mouse,
                    interactive=not args.non_interactive)
    if args.size:
        w, h = (int(v) for v in args.size.lower().split("x"))
        term.renderer.remove_framebuffer(term.fb)
        from .chexel import Framebuffer
        term.fb = Framebuffer(w, h)
        term.renderer.add_framebuffer(term.fb)
        term.fixed_size = True

    entity = BaseEntity()
    rt = RaytraceComponent(term.fb, ss=args.ss, start_scene=args.scene,
                           enable_world=not args.no_world, batch=args.batch,
                           device=args.device)
    entity.add_component(rt)
    term.add_entity(entity)
    term.on_resize = rt.resize

    if args.profile:
        from ..utils.profiling import device_trace
        with device_trace(args.profile):
            term.start(max_frames=args.frames, target_fps=args.fps)
    else:
        term.start(max_frames=args.frames, target_fps=args.fps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
