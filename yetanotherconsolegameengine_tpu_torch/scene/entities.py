"""Scene entity layer: per-frame dynamic updates to scene tables.

Port of ``yetanotherconsolegameengine_tpu/scene/entities.py``. The C#
original's ISceneEntity (Scenes/Scene.cs:537-542) mutates its Hittables
and requests BVH rebuilds; its dynamic entities live in
TestScenesRandom.cs:708-829 (BobbingSphereEntity, OrbitingLightEntity,
PulsingLightEntity, UVWobbleEntity).

Here an entity is a pure function of (scene, t): ``apply`` returns a new
``SceneData`` whose patched table is a clone of the base's with one row
set, so the base scene's tensors are never written and
``DynamicScene.at_time(t)`` stays a pure function of ``t``. ``t`` is a
Python float, the patched values are host math (``_sin`` / ``_cos``), and
each lands in the clone as a scalar fill: no upload and no wait on the
device per frame, and the same rows on the card as on the CPU.
Primitive tables are swept without an acceleration structure, so these
patches rebuild nothing. The spinning mesh rotates its base vertices on
their device and rebuilds their LBVH there (``ops/lbvh.build_lbvh``)
every frame.

``DynamicScene.to(device)`` moves the base scene and the entities'
tensors together, so a dynamic scene renders on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np
import torch

from ..ops.lbvh import build_lbvh
from .tables import MeshSoup, SceneData


def _sin(x: float) -> float:
    """Host sine of a frame time: the batched and unbatched frame loops
    both pass Python floats, so both patch bit-identical rows."""
    return math.sin(x)


def _cos(x: float) -> float:
    return math.cos(x)


def _set_row(x: torch.Tensor, index: int, value) -> torch.Tensor:
    """A clone of ``x`` with row ``index`` set to ``value`` (a float, or a
    sequence of floats for a vector row), each element a scalar fill."""
    out = x.clone()
    if isinstance(value, (tuple, list)):
        for j, v in enumerate(value):
            out[index, j] = v
    else:
        out[index] = value
    return out


class SceneEntity:
    """Protocol: patch the scene for time ``t`` (seconds)."""

    def apply(self, scene: SceneData, t: float) -> SceneData:
        raise NotImplementedError

    def to(self, device) -> "SceneEntity":
        """This entity with its tensors on ``device`` (none by default)."""
        return self


@dataclasses.dataclass
class BobbingSphereEntity(SceneEntity):
    """Sphere bobbing on Y (BobbingSphereEntity, TestScenesRandom.cs:708)."""

    index: int
    base_center: Sequence[float]
    amplitude: float = 0.5
    freq_hz: float = 0.4

    def apply(self, scene, t):
        y = self.base_center[1] + self.amplitude * _sin(
            2.0 * math.pi * self.freq_hz * t)
        center = _set_row(scene.spheres.center, self.index,
                          (self.base_center[0], y, self.base_center[2]))
        return dataclasses.replace(
            scene, spheres=dataclasses.replace(scene.spheres, center=center))


@dataclasses.dataclass
class OrbitingLightEntity(SceneEntity):
    """Light circling a pivot (OrbitingLightEntity)."""

    index: int
    pivot: Sequence[float]
    radius: float = 3.0
    height: float = 3.0
    period_s: float = 6.0

    def apply(self, scene, t):
        ang = 2.0 * math.pi * t / self.period_s
        pos = (self.pivot[0] + self.radius * _cos(ang),
               self.pivot[1] + self.height,
               self.pivot[2] + self.radius * _sin(ang))
        lights = dataclasses.replace(
            scene.lights, pos=_set_row(scene.lights.pos, self.index, pos))
        return dataclasses.replace(scene, lights=lights)


@dataclasses.dataclass
class PulsingLightEntity(SceneEntity):
    """Light intensity breathing (PulsingLightEntity)."""

    index: int
    base_intensity: float
    depth: float = 0.5        # fraction of base
    freq_hz: float = 0.8

    def apply(self, scene, t):
        k = 1.0 + self.depth * _sin(2.0 * math.pi * self.freq_hz * t)
        lights = dataclasses.replace(
            scene.lights,
            intensity=_set_row(scene.lights.intensity, self.index,
                               self.base_intensity * k))
        return dataclasses.replace(scene, lights=lights)


@dataclasses.dataclass
class UVWobbleEntity(SceneEntity):
    """Wobbles a material's UV scale (UVWobbleEntity)."""

    mat_id: int
    base_scale: float = 1.0
    depth: float = 0.3
    freq_hz: float = 0.5

    def apply(self, scene, t):
        k = self.base_scale * (1.0 + self.depth * _sin(
            2.0 * math.pi * self.freq_hz * t))
        mats = dataclasses.replace(
            scene.materials,
            uv_scale=_set_row(scene.materials.uv_scale, self.mat_id, k))
        return dataclasses.replace(scene, materials=mats)


def spin_vertices(v: torch.Tensor, ang: np.float32,
                  pivot: Sequence[float]) -> torch.Tensor:
    """Rotate (T, 3) vertices by ``ang`` about the Y axis through
    ``pivot``, on their device: the cosine and sine of the float32 angle
    in float32 (host numpy, as the JAX package's ``_spin_lbvh`` takes them
    in float32), the pivot float32 scalars, the JAX package's order of
    operations."""
    ca, sa = float(np.cos(ang)), float(np.sin(ang))
    px, py, pz = (float(np.float32(c)) for c in pivot)
    p0, p1, p2 = v[:, 0] - px, v[:, 1] - py, v[:, 2] - pz
    x = p0 * ca + p2 * sa
    z = -p0 * sa + p2 * ca
    return torch.stack([x + px, p1 + py, z + pz], dim=1)


@dataclasses.dataclass
class SpinningMeshEntity(SceneEntity):
    """Rigid mesh spinning about Y with a per-frame LBVH rebuild on its
    device: the C# GeometryDirty -> Scene.RebuildBVH path
    (Scenes/Scene.cs:66-69,122-127). Every rebuild has the same shapes
    (the same triangle count)."""

    a0: torch.Tensor     # (T, 3) base vertices
    b0: torch.Tensor
    c0: torch.Tensor
    mat: torch.Tensor    # (T,) i32 material ids
    pivot: Sequence[float]
    spin_hz: float = 0.12

    def to(self, device):
        return dataclasses.replace(
            self, a0=self.a0.to(device), b0=self.b0.to(device),
            c0=self.c0.to(device), mat=self.mat.to(device))

    def apply(self, scene, t):
        ang = np.float32(2.0 * math.pi * self.spin_hz * t)
        a, b, c = (spin_vertices(v, ang, self.pivot)
                   for v in (self.a0, self.b0, self.c0))
        # The soup follows the mesh, so moving the scene rebuilds this
        # frame's tree.
        return dataclasses.replace(scene, mesh=build_lbvh(a, b, c, self.mat),
                                   mesh_soup=MeshSoup(a, b, c, self.mat))


class DynamicScene:
    """A SceneData plus its entities: ``at_time(t)`` is the frame's scene
    (the Scene.Update + GeometryDirty path, Scene.cs:100-127)."""

    def __init__(self, base: SceneData, entities: List[SceneEntity]):
        self.base = base
        self.entities = entities
        self.t = 0.0

    @property
    def device(self) -> torch.device:
        return self.base.device

    def to(self, device) -> "DynamicScene":
        """This scene, base and entities, on ``device`` (its time kept)."""
        moved = DynamicScene(self.base.to(device),
                             [e.to(device) for e in self.entities])
        moved.t = self.t
        return moved

    def update(self, dt: float) -> SceneData:
        self.t += dt
        return self.at_time(self.t)

    def at_time(self, t: float) -> SceneData:
        scene = self.base
        for e in self.entities:
            scene = e.apply(scene, t)
        return scene
