"""The headline number: the Cornell Box at 160x90 cells on the card.

    python -m yetanotherconsolegameengine_tpu_torch.bench

The JAX package's ``bench.py`` configuration (160x90 cells = 160x180
traced pixels, ss=1: one diffuse bounce and a shadow ray per light, TAA,
a-trous, tone map and ANSI quantization on the device) rendered through
``render_many``: one warm-up batch of 2000 frames, then 3 batches of 2000
between CUDA events (``bench_suite.sustained``). Prints ONE JSON line:

    {"metric": ..., "value": Mray/s, "unit": "Mray/s",
     "vs_baseline": value / 500}

500 Mray/s is the JAX package's north-star target (BASELINE.json). Runs on
the card; raises without one unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import json

import torch

from .bench_suite import sustained
from .devices import resolve_device
from .render.renderer import RaytraceRenderer
from .scene.builders import build_cornell_box


def run(fb_w=160, fb_h=90, batch=2000, n_batches=3, device="cuda") -> dict:
    """The result line as a dict."""
    dev = resolve_device(device)
    r = RaytraceRenderer(build_cornell_box(), fb_w, fb_h, device=dev)
    ms, _, out = sustained(lambda: r.render_many(batch), batch, n_batches,
                           dev)
    rays = int(out.rays_traced)
    fps = 1e3 / ms
    mrays = rays * fps / 1e6
    impl = (f"torch+CUDA kernels on {torch.cuda.get_device_name(dev)}"
            if dev.type == "cuda" else "torch on the CPU")
    return {"metric": (f"Mrays/s, {impl}, Cornell Box @{fb_w}x{fb_h} cells "
                       f"({fb_w}x{fb_h * 2} px, {rays} rays/frame, "
                       f"{fps:.1f} fps)"),
            "value": mrays, "unit": "Mray/s", "vs_baseline": mrays / 500.0}


def main() -> None:
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
