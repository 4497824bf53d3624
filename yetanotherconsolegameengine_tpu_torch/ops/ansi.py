"""ANSI-256 and 16-color console quantization.

Port of ``yetanotherconsolegameengine_tpu/ops/ansi.py``: ``rgb_to_ansi256``
with the xterm 6-level cube and 24-step gray ramp, the chroma gate and the
+64 gray penalty; ``rgb_to_console16``, the nearest color of the 16-color
console palette.
"""

from __future__ import annotations

import numpy as np
import torch

CUBE_SRGB = np.array([0, 95, 135, 175, 215, 255], np.float32)
GRAY_SRGB = np.array([8 + 10 * i for i in range(24)], np.float32)

# The 16-color console palette (Renderer/Chexel.cs of the C# original).
PALETTE16 = np.array([
    [0.00, 0.00, 0.00], [0.00, 0.00, 0.50], [0.00, 0.50, 0.00],
    [0.00, 0.50, 0.50], [0.50, 0.00, 0.00], [0.50, 0.00, 0.50],
    [0.50, 0.50, 0.00], [0.75, 0.75, 0.75], [0.50, 0.50, 0.50],
    [0.00, 0.00, 1.00], [0.00, 1.00, 0.00], [0.00, 1.00, 1.00],
    [1.00, 0.00, 0.00], [1.00, 0.00, 1.00], [1.00, 1.00, 0.00],
    [1.00, 1.00, 1.00]], np.float32)


def linear_to_srgb8(c):
    c = torch.clamp(c, 0.0, 1.0)
    s = torch.where(c <= 0.0031308, 12.92 * c,
                    1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)
    return torch.round(torch.clamp(s * 255.0, 0.0, 255.0))


def _cube_level(v):
    return ((v >= 48).to(torch.int32) + (v >= 114).to(torch.int32)
            + (v >= 154).to(torch.int32) + (v >= 194).to(torch.int32)
            + (v >= 234).to(torch.int32))


def rgb_to_ansi256(rgb):
    """(..., 3) linear RGB in [0, 1] -> (...,) int32 ANSI-256 index."""
    r = linear_to_srgb8(rgb[..., 0])
    g = linear_to_srgb8(rgb[..., 1])
    b = linear_to_srgb8(rgb[..., 2])
    ir, ig, ib = _cube_level(r), _cube_level(g), _cube_level(b)
    idx_cube = 16 + 36 * ir + 6 * ig + ib
    cube = torch.from_numpy(CUBE_SRGB).to(rgb.device)
    cr, cg, cb = cube[ir.long()], cube[ig.long()], cube[ib.long()]
    y = linear_to_srgb8(0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1]
                        + 0.0722 * rgb[..., 2])
    gray_idx = torch.clamp(torch.round((y - 8.0) / 10.0), 0, 23).to(torch.int32)
    gray_v = torch.from_numpy(GRAY_SRGB).to(rgb.device)[gray_idx.long()]
    chroma = torch.maximum((r - g).abs(),
                           torch.maximum((r - b).abs(), (g - b).abs()))
    d_cube = (r - cr) ** 2 + (g - cg) ** 2 + (b - cb) ** 2
    d_gray = (r - gray_v) ** 2 + (g - gray_v) ** 2 + (b - gray_v) ** 2 + 64.0
    use_gray = (chroma <= 18.0) & (d_gray < d_cube)
    return torch.where(use_gray, 232 + gray_idx, idx_cube).to(torch.int32)


def rgb_to_console16(rgb):
    """(..., 3) RGB -> (...,) int32 index of the nearest palette color (the
    first one on a tie)."""
    pal = torch.from_numpy(PALETTE16).to(rgb.device)
    d = ((rgb[..., None, :] - pal) ** 2).sum(dim=-1)
    return torch.argmin(d, dim=-1).to(torch.int32)
