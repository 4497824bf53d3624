"""Native (C++) runtime helpers, loaded via ctypes.

Copied from ``yetanotherconsolegameengine_tpu/native/``. The helpers cover
the host-side per-cell loops the C# original kept native-fast
(single-syscall ANSI frame encoding, ANSITerminalRenderer.cs:226-242).
``load()`` compiles ``ansi_encoder.cpp`` with g++ on first use into
``build/native/`` at the root of the checkout (gitignored), named by a
hash of the source, and loads it; every entry point has a numpy fallback
so the shell works without a toolchain."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "ansi_encoder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _so_path() -> Path:
    key = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libyacge_native_{key}.so"


def _build(so: Path) -> bool:
    """Compile to a private name, then rename: concurrent builders (test
    workers) never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if r.returncode != 0:
        return False
    os.replace(tmp, so)
    return True


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it on first call; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _so_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.yacge_ansi_max_bytes.restype = ctypes.c_int
        lib.yacge_ansi_max_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.yacge_ansi_encode.restype = ctypes.c_int
        lib.yacge_ansi_encode.argtypes = [i32p, i32p, i32p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int, u8p]
        lib.yacge_ansi_encode_diff.restype = ctypes.c_int
        lib.yacge_ansi_encode_diff.argtypes = [i32p, i32p, i32p, i32p, i32p,
                                               i32p, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int,
                                               u8p]
        _lib = lib
        return _lib
