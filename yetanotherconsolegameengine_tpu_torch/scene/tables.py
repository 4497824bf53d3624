"""Scene as structure-of-arrays tensor tables.

Port of ``yetanotherconsolegameengine_tpu/scene/tables.py`` for primitive
scenes, meshes and textures. ``SceneBuilder`` is the same imperative host
builder, in numpy only (the JAX one returns jnp arrays), and pads every
table to the same power-of-two bucket with ``mask=False`` rows, so its
tables equal the JAX package's element for element. A mesh of at least
``CLUSTER_MIN_TRIS`` triangles builds cluster tables (ops/mesh_clusters.py)
and, by the same routing rules, its fine, LOD and shadow proxy sets
(scene/lod.py) with composed ``t_bias``; a smaller one builds an LBVH
(ops/lbvh.py) from its triangle soup, which the scene keeps: moving the
scene to another device (``SceneData.to``) rebuilds the LBVH there, so on
the card it is built on the card. Textures form one (T, H, W, 3) bank
padded to the largest image; a video texture is a bank slot that the
renderer refreshes from its reader (video/textures.py). A voxel grid
(ops/dda.py) rides in ``voxels``, which the voxel builders
(scene/voxel_scenes.py) and the streamed world (world/volume_scene.py) set.
``scene_from_numpy`` carries a JAX ``SceneData`` flattened to numpy (see
``SceneData.to_numpy`` for the keys) into the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.dda import VoxelWorld
from ..ops.lbvh import build_lbvh
from ..ops.mesh_bvh import MeshBVH
from ..ops.mesh_clusters import (MeshClusters, build_clusters,
                                 gmat_from_jax)
from ._tensors import Tensors
from .lod import simplify_soup
from .materials import Material, MaterialBank, MaterialTable, check_procs

# Meshes of at least this many triangles build cluster tables; smaller ones
# build an LBVH.
CLUSTER_MIN_TRIS = 16384
# Secondary-ray (shadow / bounce) LOD proxy budget; built when it reduces
# the mesh at least 4x.
LOD_TARGET_TRIS = 24576
# Occlusion-only proxy budget; built when the LOD set is at least 2x it.
SHADOW_LOD_TARGET_TRIS = 6144
# Primary-ray fine proxy budget; built for meshes of at least 3x it.
PRIMARY_LOD_TARGET_TRIS = 98304
# Proxy sets pack 512-triangle clusters (the full mesh 256).
PROXY_KC = 512
CLUSTER_SETS = ("mesh_clusters", "mesh_clusters_lod", "mesh_clusters_fine",
                "mesh_clusters_shadow")
_CLUSTER_FIELDS = ("cbmin", "cbmax", "gmat", "tri_rows", "bounds")
_MESH_FIELDS = tuple(f.name for f in dataclasses.fields(MeshBVH))
_VOXEL_FIELDS = tuple(f.name for f in dataclasses.fields(VoxelWorld))

PRIMITIVE_TABLES = ("spheres", "boxes", "rects", "cylinders", "disks",
                    "planes", "triangles")
_VECTORS = ("ambient_color", "ambient_intensity", "bg_top", "bg_bottom")


def _pad_rows(arr: np.ndarray, n: int) -> np.ndarray:
    pad = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _table(cls, count: int, **cols):
    """A padded table of ``cls`` from host column lists; a zero-count
    table has zero rows."""
    nb = _bucket(count) if count else 0
    mask = np.zeros(nb, np.bool_)
    mask[:count] = True
    out = {}
    for key, (vals, dtype, width) in cols.items():
        a = (np.asarray(vals, dtype) if count
             else np.zeros((0, width) if width else 0, dtype))
        out[key] = torch.from_numpy(_pad_rows(a, nb))
    return cls(mask=torch.from_numpy(mask), **out)


@dataclasses.dataclass(frozen=True)
class SphereTable(Tensors):
    center: torch.Tensor   # (N, 3)
    radius: torch.Tensor   # (N,)
    mat: torch.Tensor      # (N,) i32
    mask: torch.Tensor     # (N,) bool


@dataclasses.dataclass(frozen=True)
class BoxTable(Tensors):
    bmin: torch.Tensor     # (N, 3)
    bmax: torch.Tensor     # (N, 3)
    mat: torch.Tensor
    mask: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RectTable(Tensors):
    """Axis-aligned rectangles: ``axis`` is the fixed coordinate, (u, v)
    span the other two axes in ascending order."""

    axis: torch.Tensor     # (N,) i32
    k: torch.Tensor
    u0: torch.Tensor
    u1: torch.Tensor
    v0: torch.Tensor
    v1: torch.Tensor
    mat: torch.Tensor
    mask: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CylinderTable(Tensors):
    """Y-axis capped cylinders."""

    cx: torch.Tensor
    cz: torch.Tensor
    radius: torch.Tensor
    ymin: torch.Tensor
    ymax: torch.Tensor
    capped: torch.Tensor   # (N,) bool
    mat: torch.Tensor
    mask: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DiskTable(Tensors):
    center: torch.Tensor   # (N, 3)
    normal: torch.Tensor   # (N, 3) unit
    radius: torch.Tensor
    mat: torch.Tensor
    mask: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PlaneTable(Tensors):
    normal: torch.Tensor   # (N, 3) unit
    d: torch.Tensor        # (N,) = dot(normal, point)
    mat: torch.Tensor
    mask: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TriangleTable(Tensors):
    """Cached-edge triangles (a, e1=b-a, e2=c-a, unit n)."""

    a: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    n: torch.Tensor
    mat: torch.Tensor
    mask: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LightTable(Tensors):
    pos: torch.Tensor        # (L, 3)
    color: torch.Tensor      # (L, 3)
    intensity: torch.Tensor  # (L,)
    mask: torch.Tensor       # (L,)


@dataclasses.dataclass(frozen=True)
class MeshSoup(Tensors):
    """The triangles an LBVH is built from (the builder's mesh)."""

    a: torch.Tensor     # (T, 3)
    b: torch.Tensor     # (T, 3)
    c: torch.Tensor     # (T, 3)
    mat: torch.Tensor   # (T,) i32

    def lbvh(self) -> MeshBVH:
        """The LBVH of these triangles, built on their device."""
        return build_lbvh(self.a, self.b, self.c, self.mat)


_TABLE_TYPES = dict(spheres=SphereTable, boxes=BoxTable, rects=RectTable,
                    cylinders=CylinderTable, disks=DiskTable,
                    planes=PlaneTable, triangles=TriangleTable,
                    lights=LightTable, materials=MaterialTable)


@dataclasses.dataclass(frozen=True)
class SceneData(Tensors):
    """A scene's tables; ``to(device)`` moves every table (and rebuilds
    the LBVH on the new device when the scene keeps its mesh soup)."""

    materials: MaterialTable
    spheres: SphereTable
    boxes: BoxTable
    rects: RectTable
    cylinders: CylinderTable
    disks: DiskTable
    planes: PlaneTable
    triangles: TriangleTable
    lights: LightTable
    ambient_color: torch.Tensor      # (3,)
    ambient_intensity: torch.Tensor  # ()
    bg_top: torch.Tensor             # (3,)
    bg_bottom: torch.Tensor          # (3,)
    name: str
    binary_shadows: bool
    defaults: Tuple[float, ...]      # (px, py, pz, yaw, pitch, fov)
    # Does any material have transparency > 0? False lets the wavefront
    # trace drop its refraction stack.
    any_transparent: bool = True
    # Cluster tables of the scene's mesh and its proxy sets (None: absent).
    # Primary rays trace the fine set, bounces the LOD set and shadow rays
    # the shadow set when present (ops/intersect.py).
    mesh_clusters: Optional[MeshClusters] = None
    mesh_clusters_lod: Optional[MeshClusters] = None
    mesh_clusters_fine: Optional[MeshClusters] = None
    mesh_clusters_shadow: Optional[MeshClusters] = None
    # Every mesh material opaque? Then shadow sweeps run in any-hit mode.
    mesh_all_opaque: bool = True
    # The LBVH of a mesh under CLUSTER_MIN_TRIS triangles, and the soup it
    # was built from (None for a scene carried across from numpy).
    mesh: Optional[MeshBVH] = None
    mesh_soup: Optional[MeshSoup] = None
    # (T, H, W, 3) texture bank; a video texture's slot changes per frame.
    textures: Optional[torch.Tensor] = None
    has_dynamic_textures: bool = False
    # Dense voxel grid traced by the DDA (None: absent).
    voxels: Optional[VoxelWorld] = None

    @property
    def device(self) -> torch.device:
        return self.ambient_color.device

    def to(self, device):
        moved = super().to(device)
        if self.mesh_soup is not None and moved.device != self.device:
            moved = dataclasses.replace(moved, mesh=moved.mesh_soup.lbvh())
        return moved

    @property
    def default_pose(self):
        from ..core.camera import CameraPose
        px, py, pz, yaw, pitch, fov = self.defaults
        return CameraPose.create((px, py, pz), yaw, pitch, fov,
                                 device=self.device)

    def to_numpy(self) -> dict:
        """Flat ``{"<table>.<field>": array, ...}`` view of the scene, the
        format ``scene_from_numpy`` reads."""
        d = {}
        for tname in _TABLE_TYPES:
            tb = getattr(self, tname)
            for f in dataclasses.fields(tb):
                d[f"{tname}.{f.name}"] = getattr(tb, f.name).cpu().numpy()
        for k in _VECTORS:
            d[k] = getattr(self, k).cpu().numpy()
        d["name"] = np.asarray(self.name)
        d["binary_shadows"] = np.asarray(self.binary_shadows)
        d["defaults"] = np.asarray(self.defaults, np.float64)
        if self.mesh_clusters is not None:
            for sname in CLUSTER_SETS:
                mc = getattr(self, sname)
                if mc is None:
                    continue
                for f in _CLUSTER_FIELDS:
                    d[f"{sname}.{f}"] = getattr(mc, f).cpu().numpy()
                d[f"{sname}.t_bias"] = np.asarray(mc.t_bias, np.float64)
        if self.mesh is not None:
            for f in _MESH_FIELDS:
                d[f"mesh.{f}"] = getattr(self.mesh, f).cpu().numpy()
        if self.mesh is not None or self.mesh_clusters is not None:
            d["mesh_all_opaque"] = np.asarray(self.mesh_all_opaque)
        if self.textures is not None:
            d["textures"] = self.textures.cpu().numpy()
        if self.has_dynamic_textures:
            d["has_dynamic_textures"] = np.asarray(True)
        if self.voxels is not None:
            for f in _VOXEL_FIELDS:
                d[f"voxels.{f}"] = getattr(self.voxels, f).cpu().numpy()
        return d


def _clusters_from_numpy(d: dict, sname: str) -> Optional[MeshClusters]:
    """One cluster set of a flat dict; gmat may be in the JAX package's
    (C, 24, kc) layout."""
    if f"{sname}.gmat" not in d:
        return None
    gmat = np.asarray(d[f"{sname}.gmat"], np.float32)
    if gmat.shape[1] == 24:
        gmat = gmat_from_jax(gmat)
    cols = {f: torch.from_numpy(np.array(d[f"{sname}.{f}"], np.float32))
            for f in _CLUSTER_FIELDS if f != "gmat"}
    return MeshClusters(gmat=torch.from_numpy(np.array(gmat)), **cols,
                        t_bias=float(d[f"{sname}.t_bias"]))


def scene_from_numpy(d: dict) -> SceneData:
    """Build a ``SceneData`` from the flat numpy dict of ``to_numpy``.

    Raises ``KeyError`` for a key this format does not know.
    """
    known = {f"{t}.{f.name}" for t, cls in _TABLE_TYPES.items()
             for f in dataclasses.fields(cls)}
    known |= set(_VECTORS) | {"name", "binary_shadows", "defaults",
                              "mesh_all_opaque"}
    known |= {f"{sname}.{f}" for sname in CLUSTER_SETS
              for f in _CLUSTER_FIELDS + ("t_bias",)}
    known |= {f"mesh.{f}" for f in _MESH_FIELDS}
    known |= {"textures", "has_dynamic_textures"}
    known |= {f"voxels.{f}" for f in _VOXEL_FIELDS}
    unknown = set(d) - known
    if unknown:
        raise KeyError(f"unknown scene fields {sorted(unknown)}")
    tables = {t: cls(**{f.name: torch.from_numpy(
                  np.array(d[f"{t}.{f.name}"]))
                  for f in dataclasses.fields(cls)})
              for t, cls in _TABLE_TYPES.items()}
    check_procs(d["materials.proc"])
    # As the builder derives it: from every material of the bank.
    any_transparent = bool(np.any(np.asarray(d["materials.transparency"])
                                  > 0.0))
    mesh = None
    if "mesh.bmin" in d:
        mesh = MeshBVH(**{f: torch.from_numpy(np.array(d[f"mesh.{f}"]))
                          for f in _MESH_FIELDS})
    voxels = None
    if "voxels.cells" in d:
        voxels = VoxelWorld(**{f: torch.from_numpy(np.array(d[f"voxels.{f}"]))
                               for f in _VOXEL_FIELDS})
    textures = d.get("textures")
    return SceneData(
        **tables,
        **{k: torch.from_numpy(np.array(d[k], np.float32)) for k in _VECTORS},
        name=str(d["name"]), binary_shadows=bool(d["binary_shadows"]),
        defaults=tuple(float(v) for v in np.asarray(d["defaults"])),
        any_transparent=any_transparent,
        mesh_all_opaque=bool(d.get("mesh_all_opaque", True)),
        mesh=mesh,
        textures=(None if textures is None
                  else torch.from_numpy(np.array(textures, np.float32))),
        has_dynamic_textures=bool(d.get("has_dynamic_textures", False)),
        voxels=voxels,
        **{sname: _clusters_from_numpy(d, sname) for sname in CLUSTER_SETS})


class SceneBuilder:
    """Imperative host-side scene construction -> one SceneData."""

    def __init__(self, name: str = "scene"):
        self.name = name
        self.bank = MaterialBank()
        self._spheres: list = []
        self._boxes: list = []
        self._rects: list = []
        self._cylinders: list = []
        self._disks: list = []
        self._planes: list = []
        self._triangles: list = []
        self._lights: list = []
        self._mesh_tris: list = []   # (tris (N, 3, 3), mat_id)
        self.textures: list = []     # (H, W, 3) float32 images
        self.has_dynamic_textures = False
        self.ambient_color = (1.0, 1.0, 1.0)
        self.ambient_intensity = 0.075
        self.bg_top = (0.6, 0.8, 1.0)
        self.bg_bottom = (1.0, 1.0, 1.0)
        self.binary_shadows = False
        self.voxels: Optional[VoxelWorld] = None
        self.default_pos = (0.0, 1.0, 0.0)
        self.default_yaw = 0.0
        self.default_pitch = 0.0
        self.default_fov = 60.0

    def _mid(self, mat: Material) -> int:
        return self.bank.add(mat)

    def add_sphere(self, center, radius, mat: Material):
        self._spheres.append((tuple(center), float(radius), self._mid(mat)))

    def add_box(self, bmin, bmax, mat: Material):
        self._boxes.append((tuple(bmin), tuple(bmax), self._mid(mat)))

    def add_rect(self, axis: int, k: float, u0, u1, v0, v1, mat: Material):
        self._rects.append((axis, k, u0, u1, v0, v1, self._mid(mat)))

    def add_xy_rect(self, x0, x1, y0, y1, z, mat):
        self.add_rect(2, z, x0, x1, y0, y1, mat)

    def add_xz_rect(self, x0, x1, z0, z1, y, mat):
        self.add_rect(1, y, x0, x1, z0, z1, mat)

    def add_yz_rect(self, y0, y1, z0, z1, x, mat):
        self.add_rect(0, x, y0, y1, z0, z1, mat)

    def add_cylinder(self, center, radius, ymin, ymax, capped, mat: Material):
        self._cylinders.append((center[0], center[2], radius, min(ymin, ymax),
                                max(ymin, ymax), bool(capped), self._mid(mat)))

    def add_disk(self, center, normal, radius, mat: Material):
        n = np.asarray(normal, np.float32)
        n = n / max(1e-20, float(np.linalg.norm(n)))
        self._disks.append((tuple(center), tuple(n), float(radius),
                            self._mid(mat)))

    def add_plane(self, point, normal, mat: Material):
        n = np.asarray(normal, np.float64)
        n = n / max(1e-20, float(np.linalg.norm(n)))
        d = float(np.dot(n, np.asarray(point, np.float64)))
        self._planes.append((tuple(n.astype(np.float32)), d, self._mid(mat)))

    def add_triangle(self, a, b, c, mat: Material):
        self._triangles.append((tuple(a), tuple(b), tuple(c), self._mid(mat)))

    def add_mesh_triangles(self, tris, mat: Material):
        """Bulk triangles for the mesh accel; ``tris`` is (N, 3, 3)."""
        mid = self._mid(mat)
        self._mesh_tris.append((np.asarray(tris, np.float32), mid))

    def add_texture(self, image) -> int:
        """Register a (H, W, 3) float32 linear image; returns its id."""
        self.textures.append(np.asarray(image, np.float32))
        return len(self.textures) - 1

    def add_texture_file(self, path: str) -> int:
        """Load an image file as a texture, sRGB-decoded to linear (needs
        PIL)."""
        from PIL import Image
        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        return self.add_texture(img ** 2.2)

    def add_video_texture(self, reader) -> int:
        """Bind a frame reader (``video/readers.py``) to a texture slot that
        the renderer refreshes from it; the slot starts with the reader's
        current frame (black when it has none)."""
        from ..video import textures as vidtex
        frame = reader.try_get_frame()
        if frame is not None:
            img = vidtex.frame_to_texture(frame)
        else:
            img = np.zeros((reader.height, reader.width, 3), np.float32)
        tid = self.add_texture(img)
        self.has_dynamic_textures = True
        vidtex.register(self.name, tid, reader)
        return tid

    def add_light(self, pos, color, intensity):
        self._lights.append((tuple(pos), tuple(color), float(intensity)))

    def set_camera(self, pos, yaw=0.0, pitch=0.0, fov=60.0):
        self.default_pos = tuple(pos)
        self.default_yaw = float(yaw)
        self.default_pitch = float(pitch)
        self.default_fov = float(fov)

    def _mesh_sets(self) -> dict:
        """The mesh's acceleration tables, by the JAX package's routing
        rules (scene/tables.py:428-487 there): under ``CLUSTER_MIN_TRIS``
        triangles an LBVH (and the soup it is rebuilt from), else cluster
        tables and the proxy sets."""
        tris = np.concatenate([t.reshape(-1, 3, 3)
                               for t, _ in self._mesh_tris])
        mat_ids = np.concatenate([np.full(t.reshape(-1, 3, 3).shape[0], m,
                                          np.int32)
                                  for t, m in self._mesh_tris])
        n = tris.shape[0]
        if n < CLUSTER_MIN_TRIS:
            soup = MeshSoup(*(torch.from_numpy(np.ascontiguousarray(x))
                              for x in (tris[:, 0], tris[:, 1], tris[:, 2],
                                        mat_ids)))
            return dict(mesh=soup.lbvh(), mesh_soup=soup)
        sets = dict(mesh_clusters=build_clusters(
            tris[:, 0], tris[:, 1], tris[:, 2], mat_ids))
        target = min(LOD_TARGET_TRIS, max(8192, n // 4))
        lod_tris, lod_mats, t_bias = simplify_soup(tris, mat_ids, target)
        # Secondary-ray origins sit on the fine surface when there is one,
        # so its deviation adds to the coarser sets' t_bias.
        fine_bias = 0.0
        if n >= 3 * PRIMARY_LOD_TARGET_TRIS:
            f_tris, f_mats, fine_bias = simplify_soup(
                tris, mat_ids, PRIMARY_LOD_TARGET_TRIS)
            sets["mesh_clusters_fine"] = build_clusters(
                f_tris[:, 0], f_tris[:, 1], f_tris[:, 2], f_mats,
                kc=PROXY_KC)
        if lod_tris.shape[0] <= n // 4:
            sets["mesh_clusters_lod"] = build_clusters(
                lod_tris[:, 0], lod_tris[:, 1], lod_tris[:, 2], lod_mats,
                t_bias=t_bias + fine_bias, kc=PROXY_KC)
            if lod_tris.shape[0] >= 2 * SHADOW_LOD_TARGET_TRIS:
                s_tris, s_mats, s_bias = simplify_soup(
                    lod_tris, lod_mats, SHADOW_LOD_TARGET_TRIS)
                sets["mesh_clusters_shadow"] = build_clusters(
                    s_tris[:, 0], s_tris[:, 1], s_tris[:, 2], s_mats,
                    t_bias=t_bias + fine_bias + s_bias, kc=PROXY_KC)
        return sets

    def build(self, clusters: Optional[dict] = None) -> SceneData:
        """``clusters``: prebuilt cluster sets ({"mesh_clusters": ...,
        optionally the proxy sets}) that replace the size routing of the
        added mesh triangles, as the forced test scenes need."""
        textures = None
        if self.textures:
            th = max(t.shape[0] for t in self.textures)
            tw = max(t.shape[1] for t in self.textures)
            textures = torch.from_numpy(np.stack([
                np.pad(t, ((0, th - t.shape[0]), (0, tw - t.shape[1]),
                           (0, 0))) for t in self.textures]))
        f32, i32 = np.float32, np.int32

        def col(items, idx, dtype, width=0):
            return ([it[idx] for it in items], dtype, width)

        spheres = _table(SphereTable, len(self._spheres),
                         center=col(self._spheres, 0, f32, 3),
                         radius=col(self._spheres, 1, f32),
                         mat=col(self._spheres, 2, i32))
        boxes = _table(BoxTable, len(self._boxes),
                       bmin=col(self._boxes, 0, f32, 3),
                       bmax=col(self._boxes, 1, f32, 3),
                       mat=col(self._boxes, 2, i32))
        rects = _table(RectTable, len(self._rects),
                       axis=col(self._rects, 0, i32),
                       k=col(self._rects, 1, f32),
                       u0=col(self._rects, 2, f32), u1=col(self._rects, 3, f32),
                       v0=col(self._rects, 4, f32), v1=col(self._rects, 5, f32),
                       mat=col(self._rects, 6, i32))
        cylinders = _table(CylinderTable, len(self._cylinders),
                           cx=col(self._cylinders, 0, f32),
                           cz=col(self._cylinders, 1, f32),
                           radius=col(self._cylinders, 2, f32),
                           ymin=col(self._cylinders, 3, f32),
                           ymax=col(self._cylinders, 4, f32),
                           capped=col(self._cylinders, 5, np.bool_),
                           mat=col(self._cylinders, 6, i32))
        disks = _table(DiskTable, len(self._disks),
                       center=col(self._disks, 0, f32, 3),
                       normal=col(self._disks, 1, f32, 3),
                       radius=col(self._disks, 2, f32),
                       mat=col(self._disks, 3, i32))
        planes = _table(PlaneTable, len(self._planes),
                        normal=col(self._planes, 0, f32, 3),
                        d=col(self._planes, 1, f32),
                        mat=col(self._planes, 2, i32))
        tri_items = []
        for (a, b, c, mid) in self._triangles:
            a = np.asarray(a, f32); b = np.asarray(b, f32); c = np.asarray(c, f32)
            e1, e2 = b - a, c - a
            n = np.cross(e1, e2)
            n = n / max(1e-20, float(np.linalg.norm(n)))
            tri_items.append((a, e1, e2, n.astype(f32), mid))
        triangles = _table(TriangleTable, len(tri_items),
                           a=col(tri_items, 0, f32, 3),
                           e1=col(tri_items, 1, f32, 3),
                           e2=col(tri_items, 2, f32, 3),
                           n=col(tri_items, 3, f32, 3),
                           mat=col(tri_items, 4, i32))
        lights = _table(LightTable, len(self._lights),
                        pos=col(self._lights, 0, f32, 3),
                        color=col(self._lights, 1, f32, 3),
                        intensity=col(self._lights, 2, f32))
        if clusters is None:
            clusters = self._mesh_sets() if self._mesh_tris else {}
        vec = lambda v: torch.tensor(v, dtype=torch.float32)
        return SceneData(
            materials=self.bank.build(),
            spheres=spheres, boxes=boxes, rects=rects, cylinders=cylinders,
            disks=disks, planes=planes, triangles=triangles, lights=lights,
            ambient_color=vec(self.ambient_color),
            ambient_intensity=vec(self.ambient_intensity),
            bg_top=vec(self.bg_top), bg_bottom=vec(self.bg_bottom),
            name=self.name, binary_shadows=self.binary_shadows,
            defaults=(*(float(x) for x in self.default_pos),
                      self.default_yaw, self.default_pitch, self.default_fov),
            any_transparent=any(m.transparency > 0.0
                                for m in self.bank._mats),
            mesh_all_opaque=all(self.bank._mats[mid].transparency <= 0.0
                                for _, mid in self._mesh_tris),
            textures=textures, has_dynamic_textures=self.has_dynamic_textures,
            voxels=self.voxels, **clusters)
