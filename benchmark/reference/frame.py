"""Camera rays, the per-pixel sampler and the frame loop.

A frame traces ``fb_w * ss`` by ``2 * fb_h * ss`` pixels (two pixels a
'▀' cell). Its primary rays are jittered inside each pixel by an 8x8 Bayer
tile rotated per frame by the R2 and golden-ratio sequences; each pixel's
SplitMix64 stream starts from an FNV-style hash of (x, y, frame) and the
render's salt. ``render_frames`` renders frames from a frame state (TAA
history, the last G-buffer, the auto-exposure and the last pose), each
through ``trace.trace_pixels`` and ``post.post``, and returns every
frame's cells and the state after the last.

u64 arithmetic runs on int64 tensors: addition and multiplication wrap
like unsigned arithmetic, and right shifts mask off the sign bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK64 = (1 << 64) - 1


def to_i64(c: int) -> int:
    c &= MASK64
    return c - (1 << 64) if c >= (1 << 63) else c


def shr(x, k: int):
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(z):
    z = z + to_i64(0x9E3779B97F4A7C15)
    z = (z ^ shr(z, 30)) * to_i64(0xBF58476D1CE4E5B9)
    z = (z ^ shr(z, 27)) * to_i64(0x94D049BB133111EB)
    return z ^ shr(z, 31)


R2_X, R2_Y = 0.7548776662466927, 0.5698402909980532
GOLDEN_X, GOLDEN_Y = 0.61803398875, 0.38196601125


def frac(v):
    return v - torch.floor(v)


def bayer(px, py, dtype):
    """The 8x8 Bayer value at integer pixel coordinates, in [0, 1)."""
    x, y = px & 7, py & 7
    xy = x ^ y
    v = torch.zeros_like(x)
    for i in range(3):
        v = v + ((((xy >> i) & 1) << (2 * (2 - i) + 1))
                 + (((y >> i) & 1) << (2 * (2 - i))))
    return (v.to(dtype) + 0.5) * (1.0 / 64.0)


def pixel_seed(px, py, frame: int, salt: int):
    """Per-pixel u64 seed of ``frame`` (int64 bits)."""
    u32 = lambda x: x.to(torch.int64) & 0xFFFFFFFF
    h = torch.full(px.shape, to_i64(1469598103934665603), dtype=torch.int64,
                   device=px.device)
    h = splitmix64(h ^ (u32(px) * to_i64(0x9E3779B97F4A7C15)))
    h = splitmix64(h ^ (u32(py) * to_i64(0xC2B2AE3D27D4EB4F)))
    f = torch.full(px.shape, frame, dtype=torch.int64, device=px.device)
    h = splitmix64(h ^ (u32(f) * to_i64(0x165667B19E3779F9)))
    h = splitmix64(h)
    return splitmix64(h ^ to_i64(salt))


def next_unit(state, dtype):
    """Advance the stream: (state, uniform in (0, 1) from the top 24 bits)."""
    state = splitmix64(state)
    return state, (shr(state, 40).to(dtype) + 0.5) * (1.0 / 16777216.0)


def cosine_sample_hemisphere(n, state):
    """Cosine-weighted direction about unit normals ``n`` (Duff et al.'s
    branchless basis)."""
    state, u1 = next_unit(state, n.dtype)
    state, u2 = next_unit(state, n.dtype)
    r = torch.sqrt(u1)
    phi = u2 * (2.0 * math.pi)
    x, y = r * torch.cos(phi), r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    wx, wy, wz = n[..., 0], n[..., 1], n[..., 2]
    deg = wz < -0.999999
    a = 1.0 / (1.0 + torch.where(deg, 0.0, wz))
    b = -wx * wy * a
    f = lambda c, v: torch.where(deg, torch.as_tensor(
        c, dtype=n.dtype, device=n.device), v)
    ux, uy, uz = f(0.0, 1.0 - wx * wx * a), f(-1.0, b), f(0.0, -wx)
    vx, vy, vz = f(-1.0, b), f(0.0, 1.0 - wy * wy * a), f(0.0, -wy)
    return state, torch.stack([ux * x + vx * y + wx * z,
                               uy * x + vy * y + wy * z,
                               uz * x + vz * y + wz * z], dim=-1)


def _unit(v):
    n2 = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    return v / torch.sqrt(torch.clamp(n2, min=1e-20))[..., None]


def camera_rows(pos, yaw, pitch, fov_deg, width, height, frames):
    """(N, 18) per-frame ray scalars: pos, forward, right, up, the half
    extents of the image plane and the four jitter rotations."""
    dev, dt = pos.device, pos.dtype
    fidx = frames.to(dt)
    half_h = torch.tan(0.5 * (fov_deg * (math.pi / 180.0)))
    half_w = half_h * (width / float(height))
    cp = torch.cos(pitch)
    fwd = _unit(torch.stack([torch.sin(yaw) * cp, torch.sin(pitch),
                             -torch.cos(yaw) * cp], dim=-1))
    world_up = torch.tensor([0.0, 1.0, 0.0], dtype=dt,
                            device=dev).expand_as(fwd)
    right = _unit(torch.linalg.cross(fwd, world_up))
    up = _unit(torch.linalg.cross(right, fwd))
    rots = [frac((fidx + 1.0) * c) for c in (R2_X, R2_Y, GOLDEN_X, GOLDEN_Y)]
    scal = torch.stack(torch.broadcast_tensors(half_w, half_h, *rots), dim=-1)
    return torch.cat([pos, fwd, right, up, scal], dim=-1)


def screen(x, size: int, sign: float, dtype):
    """x / size * 2 - 1 (sign -1) or 1 - x / size * 2 (sign +1), rounded
    once: fma(x, -sign * f32(2 / size), sign), exact in float64."""
    c = float(np.float32(2.0 / size))
    return (x.to(torch.float64) * (-sign * c) + sign).to(dtype)


def primary_rays(p, width, height):
    """Jittered primary rays of one frame's row ``p``: (H*W, 3) twice."""
    dev, dt = p.device, p.dtype
    px = torch.arange(width, dtype=torch.int32, device=dev)[None].expand(
        height, width)
    py = torch.arange(height, dtype=torch.int32, device=dev)[:, None].expand(
        height, width)
    base = bayer(px, py, dt)
    jx = frac(frac(base + p[14]) + p[16]) - 0.5
    jy = frac(frac(base + p[15]) + p[17]) - 0.5
    u = screen(px.to(dt) + 0.5 + jx, width, -1.0, dt)
    v = screen(py.to(dt) + 0.5 + jy, height, 1.0, dt)
    d = _unit(p[3:6] + p[6:9] * (u * p[12])[..., None]
              + p[9:12] * (v * p[13])[..., None])
    return p[0:3].expand_as(d).reshape(-1, 3), d.reshape(-1, 3), px, py


def init_state(width: int, height: int, device, dtype):
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    false = torch.zeros((), dtype=torch.bool, device=device)
    return dict(history=z(3, height, width), prev_gbuf=z(12, height, width),
                history_valid=false, ae=z() + 1.0, last_cam=z(3),
                last_yaw=z(), last_pitch=z(), have_last=false)


def render_frames(scene, cfg: dict, fb_w: int, fb_h: int, poses, fov: float,
                  state: dict, first_frame: int):
    """Render one frame a pose (``poses``: [(pos, yaw, pitch)], as float32
    values) from ``state``; frame k has the index ``first_frame + k``.
    Returns ([(top, bot, fg, bg, rays)] per frame, state after)."""
    from .post import post, should_reset
    from .trace import trace_pixels
    dev, dt = scene.ambient_color.device, scene.ambient_color.dtype
    W, H = fb_w, 2 * fb_h
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)
    n = len(poses)
    pos = f([p for p, _, _ in poses])
    yaw = f([y for _, y, _ in poses])
    pitch = f([pt for _, _, pt in poses])
    frames = ((first_frame + torch.arange(n, dtype=torch.int64, device=dev))
              & 0x7FFFFFFF)
    rows = camera_rows(pos, yaw, pitch, f([fov] * n), W, H, frames)
    prev_pos = torch.cat([state["last_cam"][None], pos[:-1]])
    prev_yaw = torch.cat([state["last_yaw"][None], yaw[:-1]])
    prev_pitch = torch.cat([state["last_pitch"][None], pitch[:-1]])
    have = torch.cat([state["have_last"][None],
                      torch.ones(n - 1, dtype=torch.bool, device=dev)])
    resets = should_reset(pos, yaw, pitch, prev_pos, prev_yaw, prev_pitch,
                          have, cfg)
    out = []
    for k in range(n):
        o, d, px, py = primary_rays(rows[k], W, H)
        seed = pixel_seed(px, py, int(frames[k]), cfg["seed_salt"])
        gbuf = trace_pixels(scene, o, d, seed.reshape(-1), cfg) \
            .T.reshape(12, H, W).contiguous()
        blended, mapped, idx, ae = post(
            gbuf, state["prev_gbuf"], state["history"],
            state["history_valid"], resets[k], state["ae"], cfg)
        img = mapped.permute(1, 2, 0)
        rays = int(gbuf[11].to(torch.int64).sum())
        out.append((img[0::2], img[1::2], idx[0::2], idx[1::2], rays))
        state = dict(history=blended, prev_gbuf=gbuf,
                     history_valid=torch.ones((), dtype=torch.bool,
                                              device=dev),
                     ae=ae, last_cam=pos[k], last_yaw=yaw[k],
                     last_pitch=pitch[k],
                     have_last=torch.ones((), dtype=torch.bool, device=dev))
    return out, state
