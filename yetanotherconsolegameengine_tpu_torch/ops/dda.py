"""Voxel grid traversal: the restart DDA with a distance-field jump.

Port of ``yetanotherconsolegameengine_tpu/ops/dda.py``. A ``VoxelWorld``
holds one int16 cell per voxel: a positive cell is a material-bank id, any
other cell is -(D+1) with D the Chebyshev distance in cells to the nearest
solid cell, capped at ``MAX_DIST``. Every round of ``intersect_voxels``
does, for each ray, pure arithmetic and one gather:

    p      = o + (t + eps) * d
    cell   = floor((p - origin) / h)
    solid? -> done (normal = the face of the axis crossed to enter)
    t      = max(next cell boundary, t + (D - 1) * h, t + eps)

A unit-direction ray moves at most s per axis over a distance s, so the
(D - 1)-cell jump never skips a solid cell.

``intersect_voxels`` launches the DDA kernel (``csrc/dda_kernel.cu``, one
thread a ray, one launch a sweep, no host wait, the int16 cells read as
they are) for CUDA tensors and runs the plain loop for CPU tensors. In
the plain loop the rays advance in lockstep. A finished ray (hit, left the
grid or past its tmax) changes nothing in later rounds, so the loop waits
on the host only every ``CHECK_EVERY`` rounds to see whether rays still
march, and once at most a quarter of a batch of at least ``COMPACT_MIN``
lanes does, it gathers the marching lanes (``nonzero``) into a narrower
batch, as ``ops/mesh_bvh.py`` does. Per-lane arithmetic does not depend on
the other lanes, so the result equals the uncompacted loop bit for bit, on
the card it equals the CPU bit for bit, and the kernel, which runs each
lane's rounds in one thread in the same operation order, equals it too.
(The JAX package narrows by ``argsort`` to P/4 then P/16 and selects the
normal by ``one_hot``; here a gather does both. XLA's CPU backend fuses
the boundary's ``cell * h + origin`` into one multiply-add, which the port
rounds twice, so t can differ from the JAX package's by an ulp.)
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ..devices import resolve_device, resolve_impl
from ..scene._tensors import Tensors
from ..utils import profiling
from . import kernels
from .intersect import INF, Hit, _col, _lanes, _safe_div

BRICK = 8      # grids are padded to multiples of 8^3 bricks
# Chebyshev distance cap in cells: empty-space jumps reach MAX_DIST - 1
# cells; each unit costs one min-filter pass in cell_distance_field.
MAX_DIST = 31
# Rounds between host checks for rays still marching.
CHECK_EVERY = 8
# Narrow a batch of at least this many lanes once at most a quarter of it
# still marches.
COMPACT_MIN = 1024

# The kernel's linear cell index is 32-bit.
MAX_CELLS = 2 ** 31 - 1

# Work counters of the DDA (sweeps; the plain loop's rounds, host waits and
# compactions), for the frame profiler; ``STATS.clear()`` resets them.
STATS = profiling.register("dda.stats", collections.Counter())


@dataclasses.dataclass(frozen=True)
class VoxelWorld(Tensors):
    """Dense voxel grid with the distance encoding in its cells."""

    cells: torch.Tensor       # (nx, ny, nz) i16, distance-encoded
    origin: torch.Tensor      # (3,) f32 world-space min corner
    voxel_size: torch.Tensor  # () f32

    @property
    def dims(self):
        return tuple(self.cells.shape)


def _shift(m: torch.Tensor, axis: int, step: int) -> torch.Tensor:
    """``m`` moved one cell along ``axis`` (``jnp.roll`` by ``step``), the
    cell rolled in from the far side replaced by ``MAX_DIST``."""
    out = torch.roll(m, step, axis)
    edge = [slice(None)] * 3
    edge[axis] = slice(0, 1) if step > 0 else slice(-1, None)
    out[tuple(edge)] = MAX_DIST
    return out


def cell_distance_field(cells: torch.Tensor) -> torch.Tensor:
    """Chebyshev distance to the nearest solid cell, capped at
    ``MAX_DIST``: ``MAX_DIST`` passes of a separable 3x3x3 min filter
    (integer work, equal to the JAX package's)."""
    d = torch.where(cells > 0, 0, MAX_DIST).to(torch.int16)
    for _ in range(MAX_DIST):
        m = d
        for axis in range(3):
            m = torch.minimum(m, torch.minimum(_shift(m, axis, 1),
                                               _shift(m, axis, -1)))
        d = torch.minimum(d, m + 1)
    return d


def encode_cells(cells: torch.Tensor) -> torch.Tensor:
    """Material ids -> distance-encoded cells (see ``VoxelWorld``)."""
    dist = cell_distance_field(cells)
    return torch.where(cells > 0, cells, -dist - 1).to(torch.int16)


def build_voxel_world(cells: np.ndarray, origin, voxel_size: float,
                      device="cuda") -> VoxelWorld:
    """cells: (nx, ny, nz) int material-bank ids (0 = air), padded with
    air to whole bricks and encoded on ``device`` (the card unless
    "cpu" is given)."""
    dev = resolve_device(device)
    cells = np.asarray(cells)
    pad = [(0, (-cells.shape[i]) % BRICK) for i in range(3)]
    cells = torch.from_numpy(np.pad(cells, pad).astype(np.int16)).to(dev)
    return VoxelWorld(
        cells=encode_cells(cells),
        origin=torch.as_tensor(np.asarray(origin, np.float32), device=dev),
        voxel_size=torch.tensor(voxel_size, dtype=torch.float32, device=dev))


def _step(st: dict, g: dict, work: dict = None) -> None:
    """One lockstep round on the lanes of ``st``, in place. ``g``: the
    grid constants of the sweep. ``work``, when given, sums the lanes that
    march this round and marks the cells they read (``march_work``)."""
    t, alive = st["t"], st["alive"]
    h, eps = g["h"], g["eps"]
    te = t + eps
    p = st["o"] + te[:, None] * st["d"]
    # Divide by the grid's (0-d) tensor, not a host float: CUDA turns
    # division by a host scalar into a multiply by its reciprocal.
    cell = torch.floor((p - g["gmin"]) / g["h_t"]).to(torch.int32)
    cc = torch.clamp(cell, g["zero"], g["top"])
    in_grid = (cc == cell).all(1)
    if work is not None:
        work["rounds"] += alive
    alive = alive & in_grid & (t < st["tcap"])
    lin = (cc * g["strides"]).sum(1)
    enc = g["cells"][lin]
    if work is not None:
        work["cells"][lin[alive].long()] = True
    # A lane hits at most once: after a hit it is dead for good.
    solid = alive & (enc > 0)
    st["hit"] = st["hit"] | solid
    st["t_hit"] = torch.where(solid, t, st["t_hit"])
    st["axis_hit"] = torch.where(solid, st["axis"], st["axis_hit"])
    st["mat"] = torch.where(solid, enc, st["mat"])
    alive = alive & ~solid
    # The next cell boundary on each axis, INF where the ray is parallel.
    t_axes = ((cell + st["up"]) * h + g["gmin"] - st["o"]) * st["inv"]
    t_axes = torch.where(st["flat"], INF, t_axes)
    t_new, new_axis = torch.min(t_axes, 1)   # first index of equal minima
    # Distance-field skip: (D - 1) cells, D = -enc - 1 on an empty cell.
    t_new = torch.maximum(t_new, t + torch.clamp(-2 - enc, min=0) * h)
    st["t"] = torch.where(alive, torch.maximum(t_new, te), t)
    st["axis"] = torch.where(alive, new_axis, st["axis"])
    st["alive"] = alive


_OUT = ("hit", "t_hit", "axis_hit", "mat")


def grid_constants(w: VoxelWorld, dev) -> dict:
    """The plain loop's grid constants on ``dev``, as ``_step`` reads
    them. ``h`` and ``eps`` are host floats holding f32 values (every
    product with them is the f32 product of f32 values, as in the JAX
    package); reading ``h`` waits on the host once a sweep."""
    nx, ny, nz = w.dims
    dims = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)
    h = float(w.voxel_size)
    return dict(h=h, eps=float(np.float32(1e-4) * np.float32(h)),
                gmin=w.origin.to(dev), h_t=w.voxel_size.to(dev),
                zero=torch.zeros(3, dtype=torch.int32, device=dev),
                top=dims - 1,
                strides=torch.tensor([ny * nz, nz, 1], dtype=torch.int32,
                                     device=dev),
                cells=w.cells.reshape(-1).to(dev, torch.int32))


def _start(w: VoxelWorld, o, d, tmin, tmax):
    """(the plain loop's lanes before the first round, t_start, inside,
    the grid constants)."""
    P = o.shape[0]
    dev = o.device
    g = grid_constants(w, dev)
    h = g["h"]
    t_lo = _col(tmin, o)[:, 0]
    t_hi = _col(tmax, o)[:, 0]
    inv_d = _safe_div(torch.ones_like(d), d)

    # Grid box entry and exit.
    gmin = g["gmin"]
    gmax = gmin + (g["top"] + 1).to(torch.float32) * h
    ta = (gmin[None] - o) * inv_d
    tb = (gmax[None] - o) * inv_d
    t_enter, enter_axis = torch.max(torch.minimum(ta, tb), 1)
    t_exit = torch.maximum(ta, tb).amin(1)
    t_start = torch.maximum(t_enter, t_lo)
    inside = t_enter < t_lo
    alive0 = (t_enter <= t_exit) & (t_start < t_hi) & (t_exit >= t_lo)
    st = dict(t=t_start, axis=enter_axis, alive=alive0,
              hit=torch.zeros(P, dtype=torch.bool, device=dev),
              t_hit=torch.full((P,), INF, device=dev),
              axis_hit=torch.zeros(P, dtype=torch.int64, device=dev),
              mat=torch.zeros(P, dtype=torch.int32, device=dev),
              o=o, d=d, inv=inv_d, tcap=torch.minimum(t_exit, t_hi),
              up=(d > 0.0).to(torch.int32), flat=d.abs() < 1e-12)
    return st, t_start, inside, g


def intersect_voxels(w: VoxelWorld, o, d, tmin, tmax,
                     compact: bool = True, impl=None) -> Hit:
    """Nearest solid-cell hit of (P, 3) rays, with entry-face normals;
    tmin/tmax scalar or (P,). A ray whose origin is inside the grid and
    that hits at its start has no entry face and gets ``-d``.
    ``impl``: "kernel" (the DDA kernel, one launch), "plain" (the torch
    loop), None: from the rays' device. ``compact=False`` marches every
    lane of the plain loop to the end (the reference the compacted loop
    equals)."""
    impl = resolve_impl(impl, o.device)
    STATS["sweeps"] += 1
    if impl == "kernel":
        return march(w.cells.contiguous(), w.origin, w.voxel_size,
                     o.contiguous(), d.contiguous(), _lanes(tmin, o),
                     _lanes(tmax, o))
    P = o.shape[0]
    dev = o.device
    full, t_start, inside, g = _start(w, o, d, tmin, tmax)
    cur, lanes = full, None
    while True:
        for _ in range(CHECK_EVERY):
            _step(cur, g)
        STATS["rounds"] += CHECK_EVERY
        STATS["waits"] += 1
        n_alive = profiling.sync("dda.alive", int, cur["alive"].sum())
        if n_alive == 0:
            break
        width = cur["alive"].shape[0]
        if compact and width >= COMPACT_MIN and 4 * n_alive <= width:
            keep = profiling.sync("dda.compact", torch.nonzero,
                                  cur["alive"])[:, 0]
            if lanes is not None:
                _write_back(full, cur, lanes)
            cur = {k: x[keep] for k, x in cur.items()}
            lanes = keep if lanes is None else lanes[keep]
            STATS["compactions"] += 1
    if lanes is not None:
        _write_back(full, cur, lanes)

    hit, t_hit, axis_hit = full["hit"], full["t_hit"], full["axis_hit"]
    d_axis = d.gather(1, axis_hit[:, None])[:, 0]
    n = torch.eye(3, device=dev)[axis_hit] \
        * torch.where(d_axis < 0, 1.0, -1.0)[:, None]
    n = torch.where((inside & (t_hit <= t_start + g["eps"]))[:, None], -d, n)
    z = torch.zeros(P, device=dev)
    return Hit(t=torch.where(hit, t_hit, INF), n=n, u=z, v=z,
               mat=full["mat"], hit=hit)


def _write_back(full: dict, cur: dict, lanes) -> None:
    for k in _OUT:
        full[k] = full[k].index_copy(0, lanes, cur[k])


def march(cells, origin, voxel_size, o, d, tmin, tmax) -> Hit:
    """Launch the DDA kernel: ``cells`` (nx, ny, nz) int16
    distance-encoded, of 1 to ``MAX_CELLS`` cells, ``origin`` (3,) and
    ``voxel_size`` () f32, o/d (P, 3) f32, tmin/tmax (P,) f32, all
    contiguous on one CUDA device. Returns ``intersect_voxels``'s
    ``Hit``; an empty batch launches nothing."""
    P = o.shape[0]
    if cells.dim() != 3:
        raise ValueError(f"cells must be (nx, ny, nz), got "
                         f"{tuple(cells.shape)}")
    if not 0 < cells.numel() <= MAX_CELLS:
        raise ValueError(f"cells must hold 1 to 2^31 - 1 cells (the kernel's "
                         f"cell index is 32-bit), got {cells.numel()}")
    kernels.require(cells, "cells", torch.int16)
    kernels.require(origin, "origin", torch.float32, (3,))
    kernels.require(voxel_size, "voxel_size", torch.float32, ())
    for name, x, shape in (("o", o, (P, 3)), ("d", d, (P, 3)),
                           ("tmin", tmin, (P,)), ("tmax", tmax, (P,))):
        kernels.require(x, name, torch.float32, shape)
    dev = o.device
    t = torch.empty(P, device=dev)
    n = torch.empty((P, 3), device=dev)
    z = torch.empty(P, device=dev)      # u and v: the kernel writes 0
    mat = torch.empty(P, dtype=torch.int32, device=dev)
    hit = torch.empty(P, dtype=torch.bool, device=dev)
    if P:
        nx, ny, nz = cells.shape
        err = kernels.library().yacge_dda_launch(
            cells.data_ptr(), nx, ny, nz, origin.data_ptr(),
            voxel_size.data_ptr(), o.data_ptr(), d.data_ptr(),
            tmin.data_ptr(), tmax.data_ptr(), P, t.data_ptr(), n.data_ptr(),
            z.data_ptr(), mat.data_ptr(), hit.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        kernels.check(err, "DDA kernel")
        kernels.LAUNCHES["dda"] += 1
    return Hit(t=t, n=n, u=z, v=z, mat=mat, hit=hit)


def march_counts(w: VoxelWorld, o, d, tmin, tmax):
    """Run the plain loop uncompacted to its end, counting: (a dict of the
    (P,) rounds of each ray (the rounds it enters marching, each one round
    of the kernel's loop) and the cells read (a mask over the grid), the
    lockstep rounds)."""
    st, _, _, g = _start(w, o, d, tmin, tmax)
    work = dict(rounds=torch.zeros(o.shape[0], dtype=torch.int64,
                                   device=o.device),
                cells=torch.zeros(g["cells"].shape[0], dtype=torch.bool,
                                  device=o.device))
    lockstep = 0
    while bool(st["alive"].any()):
        _step(st, g, work)
        lockstep += 1
    return work, lockstep


def march_work(w: VoxelWorld, o, d, tmin, tmax) -> dict:
    """The work these rays' marches need (``march_counts``): rounds (the
    lanes that enter a round marching, summed over rounds), the most of any
    ray, and the distinct cells read; with the lockstep rounds and the
    share of a warp's round slots that march
    (``kernels.warp_efficiency``)."""
    work, lockstep = march_counts(w, o, d, tmin, tmax)
    lane = work["rounds"]
    return {"rounds": int(lane.sum()),
            "max_rounds": int(lane.max()) if lane.numel() else 0,
            "cells": int(work["cells"].sum()), "lockstep_rounds": lockstep,
            "warp_efficiency": kernels.warp_efficiency(lane)}
