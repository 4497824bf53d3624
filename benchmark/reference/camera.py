"""The fly camera's response to held keys (Scene.HandleInput of the C#
original): W/S/A/D move 3 units a second in the yaw plane, E/space and
Q/C up and down, the arrows turn 1.6 radians a second, pitch held within
±1.45; Shift multiplies the speed by 8. Yaw 0 looks down -Z."""

from __future__ import annotations

import math

MOVE_SPEED = 3.0
BOOST = 8.0
LOOK_SPEED = 1.6
PITCH_LIMIT = 1.45


def step(pose, keys, dt: float):
    """``pose`` = [x, y, z, yaw, pitch] advanced one tick with ``keys``
    (a set of key names) held; a new list."""
    x, y, z, yaw, pitch = pose
    d = MOVE_SPEED * (BOOST if "shift" in keys else 1.0) * dt
    cy, sy = math.cos(yaw), math.sin(yaw)
    dx = dz = dy = 0.0
    if "w" in keys:
        dx += sy * d
        dz -= cy * d
    if "s" in keys:
        dx -= sy * d
        dz += cy * d
    if "a" in keys:
        dx -= cy * d
        dz -= sy * d
    if "d" in keys:
        dx += cy * d
        dz += sy * d
    if "e" in keys or " " in keys:
        dy += d
    if "q" in keys or "c" in keys:
        dy -= d
    la = LOOK_SPEED * dt
    if "left" in keys:
        yaw -= la
    if "right" in keys:
        yaw += la
    if "up" in keys:
        pitch = min(PITCH_LIMIT, pitch + la)
    if "down" in keys:
        pitch = max(-PITCH_LIMIT, pitch - la)
    if dx or dy or dz:
        x, y, z = x + dx, y + dy, z + dz
    return [x, y, z, yaw, pitch]


def call_poses(keys_at, batch: int, dt: float, defaults, calls: int):
    """The tick and the float32 poses of the first ``calls`` render calls
    of a shell loop that renders ``batch`` frames a call: one frame a tick
    (batch 1: call c at tick c, posed after the tick's keys), or ``batch``
    frames from one tick's keys replayed ``batch`` times, dispatched at
    tick 0, tick 1, and every ``batch`` ticks after (batch > 1: a batch
    is shown over the ``batch`` ticks after the one that dispatched the
    next). ``keys_at(tick)`` gives the keys held at a tick.
    Returns [(tick, [(pos, yaw, pitch), ...])]."""
    import numpy as np
    pose = [float(v) for v in defaults[:5]]
    f32 = lambda p: ([float(np.float32(v)) for v in p[:3]],
                     float(np.float32(p[3])), float(np.float32(p[4])))
    out = []
    for c in range(calls):
        tick = c if batch == 1 else (0 if c == 0 else 1 + (c - 1) * batch)
        frames = []
        for _ in range(batch):
            pose = step(pose, keys_at(tick), dt)
            frames.append(f32(pose))
        out.append((tick, frames))
    return out
