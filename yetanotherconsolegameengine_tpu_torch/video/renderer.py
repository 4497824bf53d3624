"""Video frame -> terminal cells on the render device.

Port of ``yetanotherconsolegameengine_tpu/video/renderer.py``, the
counterpart of the C# VideoRenderer (Renderer/VideoRenderer.cs:12-292):
Lanczos-3 resample -> aspect-fit -> supersample -> half-block cells. The
separable Lanczos-3 resample is two ``torch.einsum`` matrix products over
the ``_lanczos_weights`` matrices, in fp32 with TF32 off; the aspect-fit
canvas paste is a slice assignment; cells are averaged and quantized by
``ops/ansi.rgb_to_ansi256``, the ray tracer's output stage. It runs on
the device it is given, the card unless ``"cpu"`` is given.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Tuple

import numpy as np
import torch

from ..devices import resolve_device
from ..ops import ansi


def _lanczos_weights(src: int, dst: int, a: int = 3) -> np.ndarray:
    """(dst, src) resampling matrix with Lanczos-a kernel
    (VideoRenderer.cs:184-241's filter, expressed as a matmul)."""
    scale = src / dst
    out = np.zeros((dst, src), np.float32)
    support = a * max(1.0, scale)
    for i in range(dst):
        center = (i + 0.5) * scale - 0.5
        lo = int(np.floor(center - support))
        hi = int(np.ceil(center + support))
        xs = np.arange(lo, hi + 1)
        t = (xs - center) / max(1.0, scale)
        w = np.sinc(t) * np.sinc(t / a)
        w[np.abs(t) >= a] = 0.0
        xs_c = np.clip(xs, 0, src - 1)
        for x, wv in zip(xs_c, w):
            out[i, x] += wv
        s = out[i].sum()
        if s != 0:
            out[i] /= s
    return out


@functools.lru_cache(maxsize=16)
def _resample_mats(src_h: int, src_w: int, dst_h: int, dst_w: int,
                   device: str):
    return tuple(torch.from_numpy(_lanczos_weights(s, d)).to(device)
                 for s, d in ((src_h, dst_h), (src_w, dst_w)))


def _fit_rect(src_w, src_h, dst_w, dst_h) -> Tuple[int, int, int, int]:
    """Aspect-fit (x0, y0, w, h) inside the destination."""
    scale = min(dst_w / src_w, dst_h / src_h)
    w = max(1, int(round(src_w * scale)))
    h = max(1, int(round(src_h * scale)))
    return (dst_w - w) // 2, (dst_h - h) // 2, w, h


@contextlib.contextmanager
def _fp32_matmuls():
    """Full fp32 products on the card: TF32 off for the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class VideoRenderer:
    """IFrameReader -> per-frame half-block cell grids.

    The C# VideoRenderer's role behind the same output contract as
    RaytraceRenderer: (top_rgb, bot_rgb, fg_ansi, bg_ansi) tensors on the
    render device."""

    def __init__(self, reader, fb_w: int, fb_h: int, ss: int = 1,
                 device="cuda"):
        self.reader = reader
        self.fb_w, self.fb_h = fb_w, fb_h
        self.ss = max(1, ss)
        self.device = resolve_device(device)
        self._last = None

    def _convert(self, frame: np.ndarray):
        src_h, src_w = frame.shape[:2]
        hi_w = self.fb_w * self.ss
        hi_h = self.fb_h * 2 * self.ss
        x0, y0, w, h = _fit_rect(src_w, src_h, hi_w, hi_h)
        wy, wx = _resample_mats(src_h, src_w, h, w, str(self.device))
        img = torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)
        img = img.to(torch.float32) * (1.0 / 255.0)
        with _fp32_matmuls():
            # Separable Lanczos: (h,src_h)@(src_h,src_w,3) then columns.
            tmp = torch.einsum("hs,swc->hwc", wy, img)
            res = torch.einsum("dw,hwc->hdc", wx, tmp)
        res = torch.clamp(res, 0.0, 1.0)
        canvas = torch.zeros((hi_h, hi_w, 3), dtype=torch.float32,
                             device=self.device)
        canvas[y0:y0 + h, x0:x0 + w] = res
        cells = canvas.reshape(self.fb_h, 2, self.ss, self.fb_w, self.ss,
                               3).mean((2, 4))
        top = cells[:, 0]
        bot = cells[:, 1]
        return top, bot, ansi.rgb_to_ansi256(top), ansi.rgb_to_ansi256(bot)

    def render(self):
        """Returns (top_rgb, bot_rgb, fg_ansi, bg_ansi) or the previous
        frame when the reader has nothing new yet."""
        frame = self.reader.try_get_frame()
        if frame is None:
            return self._last
        self._last = self._convert(frame)
        return self._last
