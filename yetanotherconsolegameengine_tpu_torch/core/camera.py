"""Camera pose and jittered primary-ray generation.

Port of ``yetanotherconsolegameengine_tpu/core/camera.py``. ``ray_params``
packs the camera basis and per-frame jitter rotations into 18 float32
scalars per frame; it is batched over any leading axes, so the frame loop
computes the rows of all N frames of a batch at once on the device (as the
JAX ``frame_scan`` hoists them) and the trace kernel reads one row per
frame. ``make_jittered_rays`` derives the same rays from one row on the
plain path.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..devices import resolve_device
from ..utils import profiling
from . import sampler


@dataclasses.dataclass(frozen=True)
class CameraPose:
    """Camera inputs of a frame, or of N frames with a leading (N,) axis."""

    pos: torch.Tensor      # (..., 3) f32
    yaw: torch.Tensor      # (...) f32
    pitch: torch.Tensor    # (...) f32
    fov_deg: torch.Tensor  # (...) f32

    @staticmethod
    def create(pos=(0.0, 1.0, 0.0), yaw=0.0, pitch=0.0, fov_deg=60.0,
               device="cuda") -> "CameraPose":
        """A pose on ``device``: the card unless ``"cpu"`` is given."""
        device = resolve_device(device)
        f = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
        return CameraPose(pos=f(pos), yaw=f(yaw), pitch=f(pitch),
                          fov_deg=f(fov_deg))


def forward_from_yaw_pitch(yaw, pitch):
    """Yaw 0 looks down -Z (RaytraceRenderer.cs:413-417)."""
    cp = torch.cos(pitch)
    return torch.stack([torch.sin(yaw) * cp, torch.sin(pitch),
                        -torch.cos(yaw) * cp], dim=-1)


def _normalize(v, eps=1e-20):
    # x*x + y*y + z*z in that order, as the trace kernel sums it.
    n2 = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    return v / torch.sqrt(torch.clamp(n2, min=eps))[..., None]


def ray_params(cam: CameraPose, width: int, height: int, frame_idx):
    """(..., 18) f32 ray-generation scalars. Layout:

    [0:3] pos  [3:6] fwd  [6:9] right  [9:12] up  [12] half_w  [13] half_h
    [14:16] R2 blue-noise rotation  [16:18] golden-ratio jitter rotation
    """
    aspect = width / float(height)
    fidx = torch.as_tensor(frame_idx, dtype=torch.int32,
                           device=cam.pos.device).to(torch.float32)
    fov_rad = cam.fov_deg * (math.pi / 180.0)
    half_h = torch.tan(0.5 * fov_rad)
    half_w = half_h * aspect
    fwd = _normalize(forward_from_yaw_pitch(cam.yaw, cam.pitch))
    # A blocking copy from the host on a card.
    world_up = profiling.sync("camera.world_up", torch.tensor,
                              [0.0, 1.0, 0.0], device=fwd.device)
    world_up = world_up.expand_as(fwd)
    right = _normalize(torch.linalg.cross(fwd, world_up))
    up = _normalize(torch.linalg.cross(right, fwd))
    f1 = fidx + 1.0
    rots = [sampler.frac(f1 * c) for c in (sampler.R2_X, sampler.R2_Y,
                                           sampler.GOLDEN_X,
                                           sampler.GOLDEN_Y)]
    scal = torch.stack(torch.broadcast_tensors(half_w, half_h, *rots), dim=-1)
    return torch.cat([cam.pos, fwd, right, up, scal], dim=-1)


def screen_coord(x: torch.Tensor, size: int, sign: float) -> torch.Tensor:
    """u = x / size * 2 - 1 (sign -1) or v = 1 - x / size * 2 (sign +1),
    rounded ONCE: fma(x, -sign * f32(2 / size), sign), as the compiled JAX
    frame program evaluates it (division by the constant becomes a product
    with its reciprocal, contracted with the add). Near the image center
    the subtraction cancels, so two roundings instead of one move rays
    that graze a far plane; the goldens hold those pixels. Emulated in
    float64, where the f32 x f32 product is exact; the trace kernel uses
    fmaf."""
    c = float(np.float32(2.0 / size))
    return (x.to(torch.float64) * (-sign * c) + sign).to(torch.float32)


def pixel_grid(width: int, height: int, device, rows=None):
    """(px, py) int32 (R, W) grids of the rows ``rows`` = (y0, y1) of a
    frame ``height`` rows tall (every row when None): global row numbers,
    so a band's rays, jitter and seeds are the whole frame's."""
    y0, y1 = (0, height) if rows is None else rows
    if not 0 <= y0 < y1 <= height:
        raise ValueError(f"rows {rows} outside a frame of {height} rows")
    px = torch.arange(width, dtype=torch.int32, device=device)[None].expand(
        y1 - y0, width)
    py = torch.arange(y0, y1, dtype=torch.int32,
                      device=device)[:, None].expand(y1 - y0, width)
    return px, py


def make_jittered_rays(cam: CameraPose, width: int, height: int, frame_idx,
                       params=None, rows=None):
    """The (H, W) grid of jittered primary rays as (origins, dirs), each
    (H, W, 3) f32. ``params``: a precomputed (18,) ray_params row.
    ``rows`` = (y0, y1): only those rows of the ``height``-row frame,
    (y1 - y0, W, 3)."""
    p = ray_params(cam, width, height, frame_idx) if params is None \
        else params
    px, py = pixel_grid(width, height, p.device, rows)
    base = sampler.bayer_base(px, py)
    jx = sampler.frac(sampler.frac(base + p[14]) + p[16]) - 0.5
    jy = sampler.frac(sampler.frac(base + p[15]) + p[17]) - 0.5
    u = screen_coord(px.to(torch.float32) + 0.5 + jx, width, -1.0)
    v = screen_coord(py.to(torch.float32) + 0.5 + jy, height, 1.0)
    pos, fwd, right, up = p[0:3], p[3:6], p[6:9], p[9:12]
    d = fwd + right * (u * p[12])[..., None] + up * (v * p[13])[..., None]
    d = _normalize(d)
    return pos.expand_as(d), d
