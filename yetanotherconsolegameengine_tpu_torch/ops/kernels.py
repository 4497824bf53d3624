"""Build the CUDA kernels of ``ops/csrc`` and bind them to PyTorch.

At first use ``library()`` compiles every ``csrc/*.cu`` (one ``nvcc``
per source, all at once), links them into one shared library with a plain
C interface under ``build/torch_kernels/`` at the root of the checkout,
named by a hash of the sources, the ``csrc/*.cuh`` headers they include
and the flags, and loads it with ``ctypes``.
Nothing is built at import time, so the CPU tests import this module on a
machine with no ``nvcc``. A failed build raises with nvcc's stderr; a
launch that returns a CUDA error raises with its message. Nothing here
falls back to the plain PyTorch versions.

``-fmad=false`` keeps the compiler from contracting a*b + c into one
rounding, so the kernels round where the plain versions round. Never
build with ``--use_fast_math``: its ``__sinf``/``__expf`` break parity.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-fmad=false")

# Launches per kernel wrapper: each wrapper adds one where it launches its
# kernel, so a run can show the main path went through the kernels.
LAUNCHES = profiling.register(
    "kernels.launches",
    {"trace": 0, "post": 0, "clusters": 0, "bvh": 0, "dda": 0, "prim": 0,
     "cluster_prep": 0, "cluster_cull": 0, "cluster_resolve": 0})

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "yacge_error_string": ([_I], ctypes.c_char_p),
    "yacge_trace_launch": ([_P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _F, _F, _F, ctypes.c_ulonglong,
                            _P], _I),
    "yacge_post_launch": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _F, _F,
                           _F, _F, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F,
                           _P], _I),
    "yacge_post_tail_launch": ([_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _I,
                                _F, _F, _F, _F, _I, _I, _F, _F, _F, _F, _F,
                                _F, _F, _F, _P], _I),
    "yacge_cluster_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _P, _P, _P, _P, _P], _I),
    "yacge_bvh_launch": ([_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P,
                          _P, _P, _P, _P, _P], _I),
    "yacge_bvh_limits": ([_I, _P], _I),
    "yacge_dda_launch": ([_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P,
                          _P, _P, _P, _P, _P], _I),
    "yacge_prim_launch": ([_P, _P, _P, _P, _P, _F, _P, _F, _I, _P, _P, _P,
                           _P, _P, _P, _P], _I),
    "yacge_cluster_prep_launch": ([_P, _P, _P, _F, _P, _F, _P, _I, _I, _I,
                                   _P, _P, _P], _I),
    "yacge_cluster_cull_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                                   _P, _P, _P], _I),
    "yacge_cluster_resolve_launch": ([_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _P, _P, _P, _P, _P, _P, _P], _I),
}


def reset_launches() -> None:
    """Zero ``LAUNCHES`` and every other total of the tracer's registry
    (``utils/profiling.py``)."""
    profiling.reset()


def warp_efficiency(lane) -> float:
    """The share of a kernel's thread slots that do work, for a kernel that
    runs ray i on thread i and loops each ray to its own end: the work of
    each ray (a (P,) tensor) summed, over the slots its warps run (a warp
    of 32 consecutive rays runs as long as its longest ray)."""
    import torch
    pad = torch.nn.functional.pad(lane, (0, -lane.shape[0] % 32))
    slots = 32 * int(pad.view(-1, 32).amax(1).sum())
    return int(lane.sum()) / slots if slots else 1.0


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: list) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libyacge_kernels_{_source_key()}.so"
    if not so.exists():
        # One nvcc per source, all started together, then one link.
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o")
                for src in sources()]
        cmds = [[nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources(), objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        for cmd, p in zip(cmds, procs):
            _, err = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                   f"{' '.join(cmd)}\n{err}")
        _run([nvcc_path(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
              *map(str, objs)])
        for obj in objs:
            obj.unlink()
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = library().yacge_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err}: {msg}")


def require(t, name: str, dtype, shape=None) -> None:
    """Check a tensor handed to a kernel: on CUDA, dtype, shape, contiguity."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
