"""Materials as a table of tensors indexed by material id.

Port of ``yetanotherconsolegameengine_tpu/scene/materials.py``. The host
``Material``/``MaterialBank`` are the same numpy-side records; the device
``MaterialTable`` holds torch tensors. ``gather_material`` is a plain row
gather (the JAX package's one-hot matmul select exists because a TPU
gather is slow). ``sample_albedo`` evaluates every procedural surface:
solid, world-XZ checker, texture (bilinear from the scene's texture bank)
and per-cell tint.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ._tensors import Tensors

PROC_SOLID = 0
PROC_CHECKER = 1
PROC_TEXTURE = 2
# Per-voxel-cell albedo tint: albedo x (1 + 0.08 ((hash(cell) % 5) - 2)).
PROC_CELL_TINT = 3
PROCS = (PROC_SOLID, PROC_CHECKER, PROC_TEXTURE, PROC_CELL_TINT)


def check_procs(proc) -> None:
    """Raise for a procedural kind that ``sample_albedo`` does not know."""
    bad = sorted({int(p) for p in np.asarray(proc).reshape(-1)} - set(PROCS))
    if bad:
        raise ValueError(f"unknown material proc {bad}; known: {PROCS}")


@dataclasses.dataclass(frozen=True)
class Material:
    """Host-side material description (hashable, deduped into the bank)."""

    albedo: Tuple[float, float, float] = (0.7, 0.7, 0.7)
    specular: float = 0.0
    reflectivity: float = 0.0
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    transparency: float = 0.0
    ior: float = 1.5
    transmission: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    proc: int = PROC_SOLID
    albedo2: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # checker 2nd color
    proc_scale: float = 1.0                                # checker cell size
    tex_id: int = -1
    tex_weight: float = 1.0
    uv_scale: float = 1.0

    @staticmethod
    def solid(albedo, specular=0.0, reflectivity=0.0, emission=(0.0, 0.0, 0.0)):
        return Material(albedo=tuple(albedo), specular=specular,
                        reflectivity=reflectivity, emission=tuple(emission))

    @staticmethod
    def emissive(emission):
        """Emissive panel: black albedo + emission."""
        return Material(albedo=(0.0, 0.0, 0.0), emission=tuple(emission))

    @staticmethod
    def checker(a, b, scale, specular=0.0, reflectivity=0.0):
        """World-XZ checker."""
        return Material(albedo=tuple(a), albedo2=tuple(b), proc=PROC_CHECKER,
                        proc_scale=scale, specular=specular,
                        reflectivity=reflectivity)

    @staticmethod
    def glass(albedo=(1.0, 1.0, 1.0), reflectivity=0.02, transparency=1.0,
              ior=1.5, transmission=(1.0, 1.0, 1.0)):
        return Material(albedo=tuple(albedo), reflectivity=reflectivity,
                        transparency=transparency, ior=ior,
                        transmission=tuple(transmission))


@dataclasses.dataclass(frozen=True)
class MaterialTable(Tensors):
    """SoA material bank (or per-pixel records after gather_material)."""

    albedo: torch.Tensor        # (M, 3)
    specular: torch.Tensor      # (M,)
    reflectivity: torch.Tensor  # (M,)
    emission: torch.Tensor      # (M, 3)
    transparency: torch.Tensor  # (M,)
    ior: torch.Tensor           # (M,)
    transmission: torch.Tensor  # (M, 3)
    proc: torch.Tensor          # (M,) int32
    albedo2: torch.Tensor       # (M, 3)
    proc_scale: torch.Tensor    # (M,)
    tex_id: torch.Tensor        # (M,) int32
    tex_weight: torch.Tensor    # (M,)
    uv_scale: torch.Tensor      # (M,)


class MaterialBank:
    """Host-side builder that dedupes ``Material``s into a MaterialTable."""

    def __init__(self):
        self._mats: list[Material] = []
        self._index: dict[Material, int] = {}
        # id 0 is a neutral gray default.
        self.add(Material())

    def add(self, mat: Material) -> int:
        idx = self._index.get(mat)
        if idx is None:
            idx = len(self._mats)
            self._mats.append(mat)
            self._index[mat] = idx
        return idx

    def __len__(self) -> int:
        return len(self._mats)

    def build(self) -> MaterialTable:
        cols = {}
        for f in dataclasses.fields(Material):
            dtype = np.int32 if f.name in ("proc", "tex_id") else np.float32
            cols[f.name] = torch.from_numpy(
                np.array([getattr(m, f.name) for m in self._mats], dtype))
        check_procs(cols["proc"].numpy())
        return MaterialTable(**cols)


def gather_material(table: MaterialTable, mat_id: torch.Tensor) -> MaterialTable:
    """Per-pixel material records for ``mat_id`` (...,) int."""
    idx = mat_id.long()
    return MaterialTable(**{f.name: getattr(table, f.name)[idx]
                            for f in dataclasses.fields(MaterialTable)})


def _i32(x: int) -> int:
    """A 32-bit pattern as the int32 value it stands for."""
    return x - (1 << 32) if x >= 1 << 31 else x


def sample_albedo(mat: MaterialTable, pos: torch.Tensor,
                  uv: Optional[torch.Tensor] = None,
                  textures: Optional[torch.Tensor] = None,
                  tint_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The procedural surface color at hit points ``pos`` (..., 3) with
    surface coordinates ``uv`` (..., 2); returns (..., 3).

    ``textures``: the scene's (T, H, W, 3) bank or None. ``tint_pos``: a
    point nudged inside the surface, so that the per-cell tint resolves
    the solid cell rather than the face; defaults to ``pos``."""
    base = mat.albedo
    cx = torch.floor(pos[..., 0] / mat.proc_scale).to(torch.int32)
    cz = torch.floor(pos[..., 2] / mat.proc_scale).to(torch.int32)
    even = ((cx + cz) & 1) == 0
    checker = torch.where(even[..., None], mat.albedo, mat.albedo2)
    out = torch.where((mat.proc == PROC_CHECKER)[..., None], checker, base)

    # Per-cell tint: an int32 hash with wrapping multiplies and arithmetic
    # shifts; % is Python's (torch.remainder), as in jnp.
    tp = pos if tint_pos is None else tint_pos
    q = [torch.floor(tp[..., i] / mat.proc_scale).to(torch.int32)
         for i in range(3)]
    hsh = ((q[0] * _i32(0x27D4EB2F)) ^ (q[1] * _i32(0x9E3779B1))
           ^ (q[2] * _i32(0x85EBCA6B)))
    hsh = hsh ^ (hsh >> 15)
    hsh = hsh * _i32(0x165667B1)
    hsh = hsh ^ (hsh >> 13)
    variant = torch.remainder(hsh.abs(), 5)
    tint = 1.0 + 0.08 * (variant.to(torch.float32) - 2.0)
    out = torch.where((mat.proc == PROC_CELL_TINT)[..., None],
                      torch.clamp(base * tint[..., None], 0.0, 1.0), out)

    if textures is not None and textures.numel() > 0:
        tiles = torch.clamp(mat.uv_scale, min=1e-6)
        tex = _sample_bilinear(textures, torch.clamp(mat.tex_id, min=0),
                               uv[..., 0] * tiles, uv[..., 1] * tiles)
        w = torch.clamp(mat.tex_weight, 0.0, 1.0)[..., None]
        blended = out * (1.0 - w) + tex * w
        use_tex = ((mat.proc == PROC_TEXTURE) & (mat.tex_id >= 0))[..., None]
        out = torch.where(use_tex, torch.clamp(blended, 0.0, 1.0), out)
    return out


def _sample_bilinear(textures, tex_id, u, v):
    """Bilinear sample of the (T, H, W, 3) bank with UV wrap and V flip.
    Indices are clamped into the bank, as a JAX gather clamps them."""
    n_tex, th, tw, _ = textures.shape
    uu = u - torch.floor(u)
    vv = 1.0 - (v - torch.floor(v))
    x = uu * (tw - 1)
    y = vv * (th - 1)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0.to(torch.float32))[..., None]
    fy = (y - y0.to(torch.float32))[..., None]
    x0 = torch.clamp(x0, 0, tw - 1)
    y0 = torch.clamp(y0, 0, th - 1)
    x1 = torch.clamp(x0 + 1, max=tw - 1)
    y1 = torch.clamp(y0 + 1, max=th - 1)
    tid = torch.clamp(tex_id.to(torch.int64), max=n_tex - 1)
    c00 = textures[tid, y0, x0]
    c10 = textures[tid, y0, x1]
    c01 = textures[tid, y1, x0]
    c11 = textures[tid, y1, x1]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy
