"""Auto-exposure + ACES filmic tone mapping + saturation.

Port of ``yetanotherconsolegameengine_tpu/ops/tonemap.py``: log-average
exposure over a strided, sky-masked sample with an EMA and [min, max]
clamp (split into per-band partials and the exposure from their sum, for
row bands); ACES curve, gamma, saturation/vibrance. The exposure stays a device
scalar tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RenderConfig
from .taa import luma


def ae_rate(cfg: RenderConfig) -> float:
    """EMA rate 1 - exp(-ae_speed), in float32 as the JAX package has it."""
    return float(np.float32(1.0) - np.exp(-np.float32(cfg.ae_speed)))


def exposure_partials(hdr, sky, sample_step: int = 2, y0: int = 0):
    """(sum of log-luma, count) over the sample grid of (H, W[, 3]) rows
    that start at global row ``y0``: the grid is every ``step``-th row and
    column of the whole image (``hdr[::step, ::step]`` of the JAX
    package), so the partials of row bands sum to the whole image's.
    0-d f32 and int64 tensors."""
    step = max(2, sample_step)
    first = -y0 % step
    lum = luma(hdr[first::step, ::step])
    use = (~sky[first::step, ::step]) & (lum > 0.0)
    log_l = torch.where(use, torch.log(1e-6 + lum), 0.0)
    return log_l.sum(), use.sum()


def exposure_from_partials(log_sum, count, ae_exposure, cfg: RenderConfig):
    """(new_ae_exposure, effective_exposure) from the whole image's
    partials: exp(sum / max(1, count)), the [min, max] clamp and the
    EMA, as the JAX package. ``count`` may be an integer or an f32
    tensor holding an integer."""
    if not cfg.auto_exposure:
        return ae_exposure, cfg.tone_exposure * ae_exposure
    avg_lum = torch.exp(log_sum / torch.clamp(count, min=1))
    target = torch.clamp(cfg.ae_key / torch.clamp(avg_lum, min=1e-6),
                         cfg.ae_min, cfg.ae_max)
    target = torch.where(count > 0, target, ae_exposure)
    new_ae = ae_exposure + (target - ae_exposure) * ae_rate(cfg)
    return new_ae, cfg.tone_exposure * new_ae


def update_exposure(hdr, sky, ae_exposure, cfg: RenderConfig,
                    sample_step: int = 2):
    """Returns (new_ae_exposure, effective_exposure), both 0-d tensors."""
    if not cfg.auto_exposure:
        return ae_exposure, cfg.tone_exposure * ae_exposure
    return exposure_from_partials(*exposure_partials(hdr, sky, sample_step),
                                  ae_exposure, cfg)


def aces_film(x):
    num = x * (2.51 * x + 0.03)
    den = x * (2.43 * x + 0.59) + 0.14
    return torch.clamp(torch.where(den > 0.0, num / den, 0.0), 0.0, 1.0)


def map_pixels(hdr, effective_exposure, cfg: RenderConfig):
    """HDR linear (..., 3) -> display-ready [0, 1]."""
    c = aces_film(torch.clamp(hdr, min=0.0) * effective_exposure)
    c = torch.pow(torch.clamp(c, 0.0, 1.0), 1.0 / max(0.1, cfg.tone_gamma))
    y = luma(c)[..., None]
    chroma = c.amax(-1, keepdim=True) - c.amin(-1, keepdim=True)
    f = cfg.tone_saturation * (1.0 + cfg.tone_vibrance * (1.0 - chroma))
    return torch.clamp(y + (c - y) * f, 0.0, 1.0)
