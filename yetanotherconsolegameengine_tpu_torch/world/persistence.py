"""World persistence: the 'VG01' binary format.

Format parity with WorldManager.GenerateAndSaveWorld / ReloadFromExistingFile
(ConsoleGame/RayTracing/Scenes/WorldGeneration/
WorldManager.cs:410-441,609-630): 4-byte magic "VG01", little-endian int32
nx, ny, nz, then row-major (mat, meta) int32 pairs. Chunk reads go through
``np.memmap`` — the reference's memory-mapped-file chunk path
(WorldManager.cs:1015-1036)."""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

MAGIC = b"VG01"
_HEADER = struct.Struct("<4siii")


def save_world(path: str, blocks: np.ndarray, meta: np.ndarray) -> None:
    """Write (X, Y, Z) blocks+meta as interleaved (mat, meta) pairs."""
    blocks = np.asarray(blocks, np.int32)
    meta = np.asarray(meta, np.int32)
    assert blocks.shape == meta.shape and blocks.ndim == 3
    nx, ny, nz = blocks.shape
    inter = np.empty((nx, ny, nz, 2), np.int32)
    inter[..., 0] = blocks
    inter[..., 1] = meta
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(MAGIC, nx, ny, nz))
        inter.tofile(f)


def read_header(path: str) -> Tuple[int, int, int]:
    with open(path, "rb") as f:
        magic, nx, ny, nz = _HEADER.unpack(f.read(_HEADER.size))
    if magic != MAGIC:
        raise ValueError(f"not a VG01 world file: {path!r} (magic={magic!r})")
    return nx, ny, nz


def load_world(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read the whole world -> (blocks, meta)."""
    nx, ny, nz = read_header(path)
    data = np.fromfile(path, np.int32, offset=_HEADER.size)
    inter = data.reshape(nx, ny, nz, 2)
    return inter[..., 0].copy(), inter[..., 1].copy()


class WorldFile:
    """Memory-mapped chunk reader (WorldManager.DoMappedFileJob,
    WorldManager.cs:995-1053)."""

    def __init__(self, path: str):
        self.path = path
        self.shape = read_header(path)
        nx, ny, nz = self.shape
        self._mm = np.memmap(path, np.int32, mode="r", offset=_HEADER.size,
                             shape=(nx, ny, nz, 2))

    def read_chunk(self, x0: int, y0: int, z0: int,
                   size: int) -> Tuple[np.ndarray, np.ndarray]:
        """(size^3 clipped to bounds) blocks+meta at voxel offset."""
        nx, ny, nz = self.shape
        sl = self._mm[x0:min(x0 + size, nx),
                      y0:min(y0 + size, ny),
                      z0:min(z0 + size, nz)]
        return np.array(sl[..., 0]), np.array(sl[..., 1])

    def close(self):
        del self._mm
