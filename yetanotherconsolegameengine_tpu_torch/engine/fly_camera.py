"""Fly/orbit camera controller.

Copied from ``yetanotherconsolegameengine_tpu/engine/fly_camera.py``.
Reproduces Scene.HandleInput / HandleMouse semantics
(RayTracing/Scenes/Scene.cs:129-436): WASD planar movement in the yaw frame, Q/E (or space/c) vertical, arrow-key
look, Shift speed boost, 'y' toggles orbit mode around a pivot, mouse
drag rotates / wheel zooms (orbit).
"""

from __future__ import annotations

import math

MOVE_SPEED = 3.0       # units/s (Scene.cs move speed)
BOOST = 8.0            # Shift multiplier
LOOK_SPEED = 1.6       # rad/s for arrow keys
PITCH_LIMIT = 1.45
MOUSE_SENS = 0.010


class FlyCamera:
    def __init__(self, pos=(0.0, 1.0, 0.0), yaw: float = 0.0,
                 pitch: float = 0.0):
        self.pos = list(pos)
        self.yaw = float(yaw)
        self.pitch = float(pitch)
        self.orbit = False
        self.orbit_target = [0.0, 1.0, -3.0]
        self.orbit_radius = 5.0
        self._drag: tuple | None = None

    def set_pose(self, pos, yaw, pitch):
        self.pos = list(pos)
        self.yaw = float(yaw)
        self.pitch = float(pitch)

    def toggle_orbit(self):
        """'Y' key (Scene.cs:129-163): orbit around the point ahead."""
        self.orbit = not self.orbit
        if self.orbit:
            cy, sy = math.cos(self.yaw), math.sin(self.yaw)
            cp, sp = math.cos(self.pitch), math.sin(self.pitch)
            fwd = (sy * cp, sp, -cy * cp)
            self.orbit_radius = 5.0
            self.orbit_target = [self.pos[i] + fwd[i] * self.orbit_radius
                                 for i in range(3)]

    def _apply_orbit(self):
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        fwd = (sy * cp, sp, -cy * cp)
        self.pos = [self.orbit_target[i] - fwd[i] * self.orbit_radius
                    for i in range(3)]

    def update(self, inp, dt: float, allow_vertical: bool = True) -> bool:
        """Advance from held keys; returns True if the pose changed."""
        moved = False
        boost = BOOST if inp.is_key_down("shift") else 1.0
        d = MOVE_SPEED * boost * dt
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        dx = dz = dy = 0.0
        if inp.is_key_down("w"):
            dx += sy * d
            dz -= cy * d
        if inp.is_key_down("s"):
            dx -= sy * d
            dz += cy * d
        if inp.is_key_down("a"):
            dx -= cy * d
            dz -= sy * d
        if inp.is_key_down("d"):
            dx += cy * d
            dz += sy * d
        if allow_vertical:
            if inp.is_key_down("e") or inp.is_key_down(" "):
                dy += d
            if inp.is_key_down("q") or inp.is_key_down("c"):
                dy -= d
        la = LOOK_SPEED * dt
        if inp.is_key_down("left"):
            self.yaw -= la
            moved = True
        if inp.is_key_down("right"):
            self.yaw += la
            moved = True
        if inp.is_key_down("up"):
            self.pitch = min(PITCH_LIMIT, self.pitch + la)
            moved = True
        if inp.is_key_down("down"):
            self.pitch = max(-PITCH_LIMIT, self.pitch - la)
            moved = True
        if dx or dy or dz:
            moved = True
            if self.orbit:
                for i, v in enumerate((dx, dy, dz)):
                    self.orbit_target[i] += v
            else:
                self.pos[0] += dx
                self.pos[1] += dy
                self.pos[2] += dz
        if self.orbit:
            self._apply_orbit()
        return moved

    def handle_mouse(self, ev) -> bool:
        """Drag rotate / wheel zoom (Scene.HandleMouse, Scene.cs:273-436)."""
        moved = False
        if ev.wheel and self.orbit:
            self.orbit_radius = max(0.5, self.orbit_radius
                                    * (0.9 if ev.wheel > 0 else 1.1))
            self._apply_orbit()
            return True
        if ev.pressed and ev.button == 0:
            if self._drag is not None:
                ddx = ev.x - self._drag[0]
                ddy = ev.y - self._drag[1]
                # Coarse-input gate (Scene.cs: console cells are chunky).
                if abs(ddx) < 40 and abs(ddy) < 20:
                    self.yaw += ddx * MOUSE_SENS * 4
                    self.pitch = max(-PITCH_LIMIT, min(
                        PITCH_LIMIT, self.pitch - ddy * MOUSE_SENS * 8))
                    moved = True
            self._drag = (ev.x, ev.y)
        else:
            self._drag = None
        if moved and self.orbit:
            self._apply_orbit()
        return moved
