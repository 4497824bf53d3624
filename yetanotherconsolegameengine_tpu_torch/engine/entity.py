"""Minimal entity/component model (BaseEntity/BaseComponent,
Entities/BaseEntity.cs:7-61, Components/BaseComponent.cs:6-25): position
+ glyph + component list with update/input fan-out. Copied from
``yetanotherconsolegameengine_tpu/engine/entity.py``."""

from __future__ import annotations

from typing import List, Optional

from .chexel import Framebuffer


class BaseComponent:
    def __init__(self):
        self.entity: Optional["BaseEntity"] = None

    def update(self, dt: float):
        pass

    def handle_key(self, key: str) -> bool:
        """Return True when the key was consumed."""
        return False

    def handle_mouse(self, ev) -> bool:
        return False

    def draw(self, fb: Framebuffer):
        pass

    def close(self):
        """Release external resources (video readers, subprocesses)."""
        pass


class BaseEntity:
    def __init__(self, x: int = 0, y: int = 0, glyph: int = 0):
        self.x = x
        self.y = y
        self.glyph = glyph
        self.components: List[BaseComponent] = []

    def add_component(self, c: BaseComponent) -> BaseComponent:
        c.entity = self
        self.components.append(c)
        return c

    def update(self, dt: float):
        for c in self.components:
            c.update(dt)

    def handle_key(self, key: str) -> bool:
        return any(c.handle_key(key) for c in self.components)

    def handle_mouse(self, ev) -> bool:
        return any(c.handle_mouse(ev) for c in self.components)

    def close(self):
        for c in self.components:
            c.close()

    def draw(self, fb: Framebuffer):
        if self.glyph:
            fb.set_chexel(self.x, self.y, self.glyph, (1, 1, 1), (0, 0, 0),
                          15, 0)
        for c in self.components:
            c.draw(fb)
