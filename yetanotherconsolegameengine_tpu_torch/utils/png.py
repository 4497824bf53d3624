"""Golden-image export.

Copied from ``yetanotherconsolegameengine_tpu/utils/png.py``. The C#
original ships an (unused) `Framebuffer.ToPng` snapshot hook
(Renderer/Framebuffer.cs:51-100); here it is a first-class feature used by the golden-image tests: each character cell
becomes a 1x2 pixel block (top = fg color of the '▀' half-block, bottom =
bg), optionally scaled up.
"""

from __future__ import annotations

import numpy as np


def frame_to_image(top_rgb, bot_rgb, scale: int = 1) -> np.ndarray:
    """(fb_h, fb_w, 3) top/bottom cell colors -> (H, W, 3) uint8 image."""
    top = np.clip(np.asarray(top_rgb, np.float32), 0.0, 1.0)
    bot = np.clip(np.asarray(bot_rgb, np.float32), 0.0, 1.0)
    h, w, _ = top.shape
    img = np.empty((h * 2, w, 3), np.float32)
    img[0::2] = top
    img[1::2] = bot
    img = np.repeat(np.repeat(img, scale, axis=0), scale, axis=1)
    return (img * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, image: np.ndarray) -> None:
    """Minimal dependency-light PNG writer (uses PIL when available)."""
    try:
        from PIL import Image
        Image.fromarray(image).save(path)
        return
    except ImportError:
        pass
    import struct
    import zlib

    h, w, _ = image.shape
    raw = b"".join(b"\x00" + image[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
