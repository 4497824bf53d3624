"""TCP scene replication: binary snapshots of the scene tables.

Port of ``yetanotherconsolegameengine_tpu/net/scene_sync.py`` on the
port's ``SceneData``; the SCNE bytes are a wire format, so for the same
scene they equal the JAX package's byte for byte. Protocol parity with
SceneSyncProtocol / SceneSyncServer / SceneSyncClient (Scenes/
SyncScene.cs:16-571): magic 'SCNE' version 1; the snapshot carries
sky/ambient/camera defaults, all lights, the material bank (the C#
original "bakes" its procedural material closures at serialization time,
:282-401 — here materials are already a table, so baking is the
identity), and every primitive table. Mesh BVHs and voxel grids are
skipped as the C# original skips them (:393-396). Each client connection
receives one snapshot per request; clients rebuild a local SceneData on
the device they name and render with their own camera.

Framing: every table is ``name_len u16 | name | dtype_code u8 | ndim u8 |
dims i32[] | payload bytes``; numeric layout little-endian.
"""

from __future__ import annotations

import io
import socket
import struct
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..devices import resolve_device

MAGIC = b"SCNE"
VERSION = 1
_DTYPES = {0: np.float32, 1: np.int32, 2: np.bool_}
_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.int32): 1,
                np.dtype(np.bool_): 2}

# Table fields serialized per section (matches scene/tables.py SoA layout).
_TABLE_FIELDS = {
    "materials": ("albedo", "specular", "reflectivity", "emission",
                  "transparency", "ior", "transmission", "proc", "albedo2",
                  "proc_scale", "tex_id", "tex_weight", "uv_scale"),
    "spheres": ("center", "radius", "mat", "mask"),
    "boxes": ("bmin", "bmax", "mat", "mask"),
    "rects": ("axis", "k", "u0", "u1", "v0", "v1", "mat", "mask"),
    "cylinders": ("cx", "cz", "radius", "ymin", "ymax", "capped", "mat",
                  "mask"),
    "disks": ("center", "normal", "radius", "mat", "mask"),
    "planes": ("normal", "d", "mat", "mask"),
    "triangles": ("a", "e1", "e2", "n", "mat", "mask"),
    "lights": ("pos", "color", "intensity", "mask"),
}


def _write_array(buf: io.BytesIO, name: str, arr: np.ndarray):
    arr = np.ascontiguousarray(arr)
    code = _DTYPE_CODES[arr.dtype]
    nb = name.encode()
    buf.write(struct.pack("<H", len(nb)))
    buf.write(nb)
    buf.write(struct.pack("<BB", code, arr.ndim))
    buf.write(struct.pack(f"<{arr.ndim}i", *arr.shape))
    buf.write(arr.tobytes())


def _read_exact(f, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = f.read(n - len(out))
        if not chunk:
            raise EOFError("snapshot stream truncated")
        out += chunk
    return out


# Per-table payload cap: largest legitimate tables are a few MB of SoA
# floats; anything bigger means a corrupt or hostile stream, and we must
# not let peer-supplied dims drive a multi-GB allocation.
MAX_TABLE_BYTES = 64 * 1024 * 1024


def _read_array(f) -> tuple:
    (nlen,) = struct.unpack("<H", _read_exact(f, 2))
    name = _read_exact(f, nlen).decode()
    code, ndim = struct.unpack("<BB", _read_exact(f, 2))
    if code not in _DTYPES:
        raise ValueError(f"snapshot table {name!r}: unknown dtype code {code}")
    if ndim > 4:
        raise ValueError(f"snapshot table {name!r}: ndim {ndim} > 4")
    dims = struct.unpack(f"<{ndim}i", _read_exact(f, 4 * ndim))
    if any(d < 0 for d in dims):
        raise ValueError(f"snapshot table {name!r}: negative dim {dims}")
    dtype = np.dtype(_DTYPES[code])
    n_elems = 1
    for d in dims:
        n_elems *= d
    n_bytes = n_elems * dtype.itemsize
    if n_bytes > MAX_TABLE_BYTES:
        raise ValueError(
            f"snapshot table {name!r}: {n_bytes} bytes exceeds the "
            f"{MAX_TABLE_BYTES}-byte cap")
    arr = np.frombuffer(_read_exact(f, n_bytes), dtype).reshape(dims)
    return name, arr


def _host(x) -> np.ndarray:
    """A table column as numpy (a scene on the card is copied back)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def write_snapshot(scene) -> bytes:
    """SceneData -> snapshot bytes (SceneSyncProtocol.WriteSnapshot)."""
    buf = io.BytesIO()
    buf.write(MAGIC)
    buf.write(struct.pack("<I", VERSION))
    _write_array(buf, "bg_top", _host(scene.bg_top).astype(np.float32))
    _write_array(buf, "bg_bottom", _host(scene.bg_bottom).astype(np.float32))
    _write_array(buf, "ambient_color",
                 _host(scene.ambient_color).astype(np.float32))
    _write_array(buf, "ambient_intensity",
                 np.asarray([float(_host(scene.ambient_intensity))],
                            np.float32))
    _write_array(buf, "defaults", np.asarray(scene.defaults, np.float32))
    _write_array(buf, "flags",
                 np.asarray([int(scene.binary_shadows)], np.int32))
    n_tables = sum(len(v) for v in _TABLE_FIELDS.values())
    buf.write(struct.pack("<I", n_tables))
    for section, fields in _TABLE_FIELDS.items():
        tb = getattr(scene, section)
        for f in fields:
            a = _host(getattr(tb, f))
            if a.dtype == np.bool_:
                pass
            elif a.dtype.kind == "f":
                a = a.astype(np.float32)
            else:
                a = a.astype(np.int32)
            _write_array(buf, f"{section}.{f}", a)
    return buf.getvalue()


def read_snapshot(f, device="cuda"):
    """Stream -> SceneData on ``device`` (SceneSyncProtocol.ReadSnapshot +
    client-side rebuild; the card unless ``"cpu"`` is given). ``f`` is a
    binary file-like (socket.makefile('rb'))."""
    from ..scene.materials import MaterialTable
    from ..scene.tables import (BoxTable, CylinderTable, DiskTable,
                                LightTable, PlaneTable, RectTable, SceneData,
                                SphereTable, TriangleTable)

    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a)).to(dev)
    if _read_exact(f, 4) != MAGIC:
        raise ValueError("bad snapshot magic")
    (version,) = struct.unpack("<I", _read_exact(f, 4))
    if version != VERSION:
        raise ValueError(f"unsupported snapshot version {version}")
    head: Dict[str, np.ndarray] = {}
    for _ in range(6):
        name, arr = _read_array(f)
        head[name] = arr
    (n_tables,) = struct.unpack("<I", _read_exact(f, 4))
    cols: Dict[str, Dict[str, np.ndarray]] = {}
    for _ in range(n_tables):
        name, arr = _read_array(f)
        section, field = name.split(".", 1)
        cols.setdefault(section, {})[field] = arr

    def tb(cls, section, bool_fields=("mask",), int_fields=("mat", "axis",
                                                            "proc",
                                                            "tex_id")):
        kw = {}
        for field, arr in cols[section].items():
            if field in bool_fields:
                kw[field] = t(arr.astype(np.bool_))
            elif field in int_fields:
                kw[field] = t(arr.astype(np.int32))
            else:
                kw[field] = t(arr.astype(np.float32))
        return cls(**kw)

    materials = tb(MaterialTable, "materials", bool_fields=())
    return SceneData(
        materials=materials,
        spheres=tb(SphereTable, "spheres"),
        boxes=tb(BoxTable, "boxes"),
        rects=tb(RectTable, "rects"),
        cylinders=tb(CylinderTable, "cylinders",
                     bool_fields=("mask", "capped")),
        disks=tb(DiskTable, "disks"),
        planes=tb(PlaneTable, "planes"),
        triangles=tb(TriangleTable, "triangles"),
        mesh=None, mesh_clusters=None, voxels=None,  # skipped, SyncScene.cs:393-396
        lights=tb(LightTable, "lights"),
        ambient_color=t(head["ambient_color"]),
        ambient_intensity=t(head["ambient_intensity"][0]),
        bg_top=t(head["bg_top"]),
        bg_bottom=t(head["bg_bottom"]),
        textures=None,
        name="synced",
        binary_shadows=bool(head["flags"][0]),
        has_dynamic_textures=False,
        defaults=tuple(float(v) for v in head["defaults"]),
        # As the builder derives it, from every material of the bank.
        any_transparent=bool(
            (materials.transparency > 0.0).any().item()),
    )


class SceneSyncServer:
    """Serves snapshots of a (possibly mutating) scene over TCP
    (SceneSyncServer, SyncScene.cs:16-134). ``scene_provider`` is called
    under no lock per request — pass a closure that snapshots your live
    scene safely. A scene on the card is copied to the host per
    snapshot."""

    def __init__(self, scene_provider: Callable[[], object],
                 host: str = "127.0.0.1", port: int = 0):
        self.provider = scene_provider
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self):
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket):
        """One snapshot per 'SNAP' request line (ServeSnapshot)."""
        try:
            f = conn.makefile("rwb")
            while not self._stop.is_set():
                req = f.read(4)
                if req != b"SNAP":
                    break
                data = write_snapshot(self.provider())
                f.write(struct.pack("<I", len(data)))
                f.write(data)
                f.flush()
        except (OSError, EOFError, ValueError):
            pass
        finally:
            conn.close()

    def close(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=1.0)


class SceneSyncClient:
    """Connects and pulls snapshots; renders locally with its own camera
    (SceneSyncClient.Resync, SyncScene.cs:186-208). Snapshots are rebuilt
    on ``device``, the card unless ``"cpu"`` is given."""

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 device="cuda"):
        self.device = resolve_device(device)
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._f = self._sock.makefile("rwb")

    def resync(self):
        """Request + deserialize one snapshot -> SceneData."""
        self._f.write(b"SNAP")
        self._f.flush()
        (n,) = struct.unpack("<I", _read_exact(self._f, 4))
        payload = _read_exact(self._f, n)
        return read_snapshot(io.BytesIO(payload), self.device)

    def close(self):
        try:
            self._f.close()
            self._sock.close()
        except OSError:
            pass
