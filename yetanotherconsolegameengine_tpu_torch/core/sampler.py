"""Deterministic per-pixel sampling: ordered-dither jitter + SplitMix64 RNG.

Port of ``yetanotherconsolegameengine_tpu/core/sampler.py``: the 8x8 Bayer
tile rotated per frame by the R2 constants, the FNV-style per-pixel seed,
the SplitMix64 counter RNG and cosine-weighted hemisphere sampling. Every
integer result is bit-identical to the JAX package; RNG state is one int64
tensor per pixel (see ``core/u64.py``).
"""

from __future__ import annotations

import math

import torch

from . import u64

BLUE_TILE = 8

_FNV_OFFSET = 1469598103934665603
_KX = u64.to_i64(0x9E3779B97F4A7C15)
_KY = u64.to_i64(0xC2B2AE3D27D4EB4F)
_KF = u64.to_i64(0x165667B19E3779F9)

R2_X = 0.7548776662466927
R2_Y = 0.5698402909980532
GOLDEN_X = 0.61803398875
GOLDEN_Y = 0.38196601125


def frac(v: torch.Tensor) -> torch.Tensor:
    return v - torch.floor(v)


def bayer_base(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """The 8x8 Bayer value at integer pixel coords as a float32 in [0,1):
    the bit-reversed interleave of (x^y, y), gather-free."""
    x = px.to(torch.int32) & (BLUE_TILE - 1)
    y = py.to(torch.int32) & (BLUE_TILE - 1)
    xy = x ^ y
    v = torch.zeros_like(x)
    k = 3  # log2(BLUE_TILE)
    for i in range(k):
        v = v + ((((xy >> i) & 1) << (2 * (k - 1 - i) + 1))
                 + (((y >> i) & 1) << (2 * (k - 1 - i))))
    return (v.to(torch.float32) + 0.5) * (1.0 / (BLUE_TILE * BLUE_TILE))


def blue_noise(px: torch.Tensor, py: torch.Tensor, frame_idx,
               channel: int) -> torch.Tensor:
    """Ordered-dither sample in [0,1) at integer pixel coords: the Bayer
    tile value rotated per frame by R2 (``channel`` 0: x, else y),
    fract-wrapped."""
    c = R2_X if channel == 0 else R2_Y
    f = torch.as_tensor(frame_idx, device=px.device).to(torch.float32)
    return frac(bayer_base(px, py) + frac((f + 1.0) * c))


def per_frame_seed(px: torch.Tensor, py: torch.Tensor, frame_idx,
                   salt: int) -> torch.Tensor:
    """Per-pixel u64 seed (RaytraceSampler.PerFrameSeed with jx = jy = 0).
    ``frame_idx`` is an int or an integer tensor broadcastable to px."""
    f = torch.as_tensor(frame_idx, dtype=torch.int64, device=px.device)
    h = torch.full(px.shape, u64.to_i64(_FNV_OFFSET), dtype=torch.int64,
                   device=px.device)
    h = u64.splitmix64(h ^ (u64.from_u32(px) * _KX))
    h = u64.splitmix64(h ^ (u64.from_u32(py) * _KY))
    h = u64.splitmix64(h ^ (u64.from_u32(f) * _KF))
    h = u64.splitmix64(h)  # jx = jy = 0 contributes nothing to the xor
    return u64.splitmix64(h ^ u64.to_i64(salt))


def rng_next_unit(state: torch.Tensor):
    """Advance the RNG; returns (new_state, uniform float32 in (0,1)) from
    the top 24 bits, (m24 + 0.5) / 2**24."""
    state = u64.splitmix64(state)
    m24 = u64.shr(state, 40).to(torch.float32)
    return state, (m24 + 0.5) * (1.0 / 16777216.0)


def cosine_sample_hemisphere(n: torch.Tensor, state: torch.Tensor):
    """Cosine-weighted direction about unit normal ``n`` (..., 3), with the
    branchless Duff et al. basis; returns (new_state, dir (..., 3))."""
    state, u1 = rng_next_unit(state)
    state, u2 = rng_next_unit(state)
    r = torch.sqrt(u1)
    phi = u2 * (2.0 * math.pi)
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))

    wx, wy, wz = n[..., 0], n[..., 1], n[..., 2]
    degenerate = wz < -0.999999
    a = 1.0 / (1.0 + torch.where(degenerate, 0.0, wz))
    b = -wx * wy * a
    ux = torch.where(degenerate, 0.0, 1.0 - wx * wx * a)
    uy = torch.where(degenerate, -1.0, b)
    uz = torch.where(degenerate, 0.0, -wx)
    vx = torch.where(degenerate, -1.0, b)
    vy = torch.where(degenerate, 0.0, 1.0 - wy * wy * a)
    vz = torch.where(degenerate, 0.0, -wy)
    d = torch.stack([ux * x + vx * y + wx * z,
                     uy * x + vy * y + wy * z,
                     uz * x + vz * y + wz * z], dim=-1)
    return state, d
