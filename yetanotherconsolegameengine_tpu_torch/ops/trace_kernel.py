"""The trace kernel's wrapper, its scene packing and its plain version.

Port of ``yetanotherconsolegameengine_tpu/ops/pallas_trace.py``
(``build_kernel`` / ``trace_planes_pallas``): ray generation, seeding and
the whole path trace of every pixel, producing the (12, H, W) f32
G-buffer in ``PLANES`` order. The CUDA source is ``csrc/trace_kernel.cu``.

``scene_fits`` decides, before any launch, whether a scene takes the
kernel: a scene without a mesh, voxels, textures or per-cell tint whose
table and path stack fit in one block's shared memory (the JAX package's
``pallas_trace.scene_fits``, without its 160-row unroll budget, a TPU
compile limit). Every other scene traces through the wavefront
(``ops/trace.py``). ``pack_scene`` flattens a scene's tables once per
scene into one f32 row buffer plus an int32 header of row counts and
offsets, which the kernel reads at run time (the TPU kernel baked the
tables into its program). ``trace_planes`` launches the kernel for a CUDA
scene; given a scene on the CPU it runs ``trace_planes_plain``, the same
computation in plain PyTorch, because no kernel exists there.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from ..core import sampler
from ..core.camera import make_jittered_rays, pixel_grid
from ..scene.materials import PROC_CELL_TINT
from ..scene.tables import PRIMITIVE_TABLES, SceneData
from . import kernels
from .trace import stack_slots, trace_all

PLANES = ("rad_r", "rad_g", "rad_b", "sky", "alb_r", "alb_g", "alb_b",
          "n_x", "n_y", "n_z", "depth", "rays")
# Shared memory of one block of csrc/trace_kernel.cu: the header padded to
# HDR_PAD words, the packed table, then per ray ``stack_slots(cfg)``
# path-stack entries of STACK_WORDS words; THREADS rays a block.
THREADS = 128
HDR_PAD = 32
STACK_WORDS = 11
SHARED_LIMIT = 232448   # bytes a block may use on sm_90 (227 KB)
_MAT_FIELDS = ("albedo", "emission", "transmission", "albedo2", "specular",
               "reflectivity", "transparency", "ior", "proc", "proc_scale")
_ROW_FIELDS = {
    "spheres": ("center", "radius", "mat"),
    "boxes": ("bmin", "bmax", "mat"),
    "rects": ("axis", "k", "u0", "u1", "v0", "v1", "mat"),
    "cylinders": ("cx", "cz", "radius", "ymin", "ymax", "capped", "mat"),
    "disks": ("center", "normal", "radius", "mat"),
    "planes": ("normal", "d", "mat"),
    "triangles": ("a", "e1", "e2", "n", "mat"),
    "lights": ("pos", "color", "intensity"),
}


@dataclasses.dataclass(frozen=True)
class PackedScene:
    """A scene plus its kernel layout (on the scene's device)."""

    scene: SceneData
    table: torch.Tensor   # (K,) f32 rows of every table, then globals
    header: torch.Tensor  # (20,) i32 (count, offset) per table + flags


def _rows(tb, fields) -> np.ndarray:
    mask = tb.mask.cpu().numpy()
    cols = []
    for f in fields:
        a = getattr(tb, f).cpu().numpy()[mask].astype(np.float32)
        cols.append(a.reshape(a.shape[0], a.shape[1] if a.ndim == 2 else 1))
    return np.concatenate(cols, axis=1)


def table_len(scene: SceneData) -> int:
    """Floats of ``pack_scene``'s table for ``scene``: the valid rows of
    every table, the materials and the globals."""
    n = 0
    for name in PRIMITIVE_TABLES + ("lights",):
        tb = getattr(scene, name)
        width = sum(getattr(tb, f).shape[1] if getattr(tb, f).dim() == 2
                    else 1 for f in _ROW_FIELDS[name])
        n += int(tb.mask.sum()) * width
    m = scene.materials
    n += sum(getattr(m, f)[0].numel() for f in _MAT_FIELDS) \
        * m.albedo.shape[0]
    return n + 10   # ambient color and intensity, sky top and bottom


def scene_fits(scene: SceneData, cfg: RenderConfig = DEFAULT_CONFIG) -> bool:
    """Does the trace kernel take this scene? It traces primitive tables
    (no mesh, no voxel grid) with solid and checker surfaces only, and
    needs the packed table and the path stack in one block's shared
    memory."""
    if (scene.mesh is not None or scene.mesh_clusters is not None
            or scene.textures is not None or scene.voxels is not None):
        return False
    if bool((scene.materials.proc == PROC_CELL_TINT).any()):
        return False
    return shared_bytes(table_len(scene), stack_slots(cfg)) <= SHARED_LIMIT


def pack_scene(scene: SceneData) -> PackedScene:
    """Flatten the valid rows of every table for the trace kernel. The
    header order is the enum at the top of csrc/trace_kernel.cu."""
    chunks, header, off = [], [], 0
    m = scene.materials
    mats = np.concatenate([getattr(m, f).cpu().numpy().astype(np.float32)
                           .reshape(m.albedo.shape[0], -1)
                           for f in _MAT_FIELDS], axis=1)
    for name in PRIMITIVE_TABLES + ("lights",):
        rows = _rows(getattr(scene, name), _ROW_FIELDS[name])
        header += [rows.shape[0], off]
        chunks.append(rows.reshape(-1))
        off += rows.size
    header += [mats.shape[0], off]
    chunks.append(mats.reshape(-1))
    off += mats.size
    glob = np.concatenate([scene.ambient_color.cpu().numpy(),
                           scene.ambient_intensity.cpu().numpy().reshape(1),
                           scene.bg_top.cpu().numpy(),
                           scene.bg_bottom.cpu().numpy()]).astype(np.float32)
    header += [off, int(scene.binary_shadows)]
    chunks.append(glob)
    dev = scene.device
    return PackedScene(
        scene=scene,
        table=torch.from_numpy(np.concatenate(chunks)).to(dev),
        header=torch.tensor(header, dtype=torch.int32, device=dev))


def trace_planes_plain(scene: SceneData, params_row: torch.Tensor,
                       frame_idx: int, width: int, height: int,
                       cfg: RenderConfig, rows=None) -> torch.Tensor:
    """The plain version of the kernel: (12, H, W) f32 planes, or with
    ``rows`` = (y0, y1) the (12, y1 - y0, W) planes of those rows of the
    ``height``-row frame."""
    o, d = make_jittered_rays(None, width, height, frame_idx,
                              params=params_row, rows=rows)
    px, py = pixel_grid(width, height, params_row.device, rows)
    seed = sampler.per_frame_seed(px, py, frame_idx, cfg.seed_salt)
    res = trace_all(scene, o.reshape(-1, 3), d.reshape(-1, 3),
                    seed.reshape(-1), cfg, "plain")
    return result_planes(res, width, px.shape[0])


def lane_columns(res) -> torch.Tensor:
    """A TraceResult as (P, 12) f32 columns in ``PLANES`` order."""
    return torch.cat([res.radiance, res.is_sky.to(torch.float32)[:, None],
                      res.albedo, res.normal, res.depth[:, None],
                      res.lane_rays.to(torch.float32)[:, None]], dim=1)


def result_planes(res, width: int, height: int) -> torch.Tensor:
    """A TraceResult of the (H, W) pixel grid as (12, H, W) planes."""
    return lane_columns(res).T.reshape(12, height, width).contiguous()


def shared_bytes(table_len: int, slots: int) -> int:
    """Shared memory one block of the trace kernel asks for."""
    return 4 * (HDR_PAD + table_len + THREADS * slots * STACK_WORDS)


def check_shared(table_len: int, slots: int) -> None:
    """Raise if the scene table and the path stack do not fit in the
    shared memory of one block."""
    need = shared_bytes(table_len, slots)
    if need > SHARED_LIMIT:
        raise ValueError(
            f"scene table of {table_len} floats ({4 * table_len} bytes) and "
            f"a path stack of {slots} slots for {THREADS} rays need "
            f"{need} bytes of shared memory; a block has {SHARED_LIMIT}")


def trace_planes(packed: PackedScene, params: torch.Tensor,
                 frames: torch.Tensor, row: int, width: int, height: int,
                 cfg: RenderConfig, rows=None) -> torch.Tensor:
    """Trace frame ``row`` of a batch: ``params`` (N, 18) f32 ray_params
    rows and ``frames`` (N,) i32 frame indices, both on the scene's device.
    Returns the (12, H, W) f32 G-buffer; with ``rows`` = (y0, y1) the
    (12, y1 - y0, W) G-buffer of those rows of the ``height``-row frame
    (a row band: the kernel maps its pixels to global rows)."""
    if params.device.type == "cpu":
        return trace_planes_plain(packed.scene, params[row],
                                  int(frames[row]), width, height, cfg, rows)
    y0, y1 = (0, height) if rows is None else rows
    if not 0 <= y0 < y1 <= height:
        raise ValueError(f"rows {rows} outside a frame of {height} rows")
    n = params.shape[0]
    kernels.require(params, "params", torch.float32, (n, 18))
    kernels.require(frames, "frames", torch.int32, (n,))
    kernels.require(packed.table, "scene table", torch.float32)
    kernels.require(packed.header, "scene header", torch.int32, (20,))
    if not 0 <= row < n:
        raise IndexError(f"row {row} outside a batch of {n}")
    slots = stack_slots(cfg)
    check_shared(packed.table.numel(), slots)
    sigma = cfg.diffuse_sigma_deg * math.pi / 180.0
    s2 = sigma * sigma
    out = torch.empty((12, y1 - y0, width), dtype=torch.float32,
                      device=params.device)
    lib = kernels.library()
    err = lib.yacge_trace_launch(
        packed.table.data_ptr(), packed.header.data_ptr(),
        packed.table.numel(), params.data_ptr(), frames.data_ptr(), row,
        out.data_ptr(), width, height, y0, y1 - y0, cfg.max_trace_rounds,
        cfg.max_mirror_bounces, cfg.max_refractions, cfg.diffuse_bounces,
        slots, cfg.mirror_threshold,
        1.0 - s2 / (2.0 * (s2 + 0.33)), 0.45 * s2 / (s2 + 0.09),
        cfg.seed_salt & ((1 << 64) - 1),
        torch.cuda.current_stream(params.device).cuda_stream)
    kernels.check(err, "trace kernel")
    kernels.LAUNCHES["trace"] += 1
    return out
