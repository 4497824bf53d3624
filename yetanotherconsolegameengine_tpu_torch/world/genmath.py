"""Procedural noise math, numpy-vectorized over coordinate grids.

Functional parity with GenMath (ConsoleGame/RayTracing/
Scenes/WorldGeneration/GenMath.cs:7-186): hashed gradient noise 2-D/3-D,
FBM, ridged FBM, smoothstep/lerp/saturate. The reference evaluates these
per column in scalar C#; worldgen is offline host work (SURVEY.md §7 build
plan step 6, "worldgen (host numpy, it's offline)"), so everything here
takes arrays of any shape and broadcasts.
"""

from __future__ import annotations

import numpy as np

_U64 = np.uint64


def hash_u32(ix: np.ndarray, iy: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic per-lattice-point hash (GenMath.Hash semantics).
    uint64 wraparound is intentional."""
    with np.errstate(over="ignore"):
        h = (np.asarray(ix).astype(_U64) * _U64(0x9E3779B97F4A7C15)
             ^ np.asarray(iy).astype(_U64) * _U64(0xC2B2AE3D27D4EB4F)
             ^ _U64(seed & 0xFFFFFFFFFFFFFFFF))
        h ^= h >> _U64(33)
        h *= _U64(0xFF51AFD7ED558CCD)
        h ^= h >> _U64(33)
    return (h & _U64(0xFFFFFFFF)).astype(np.uint32)


def hash_u32_3(ix, iy, iz, seed: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = (np.asarray(ix).astype(_U64) * _U64(0x9E3779B97F4A7C15)
             ^ np.asarray(iy).astype(_U64) * _U64(0xC2B2AE3D27D4EB4F)
             ^ np.asarray(iz).astype(_U64) * _U64(0x165667B19E3779F9)
             ^ _U64(seed & 0xFFFFFFFFFFFFFFFF))
        h ^= h >> _U64(33)
        h *= _U64(0xFF51AFD7ED558CCD)
        h ^= h >> _U64(33)
    return (h & _U64(0xFFFFFFFF)).astype(np.uint32)


def _grad2(ix, iy, seed):
    """Unit gradient per 2-D lattice point."""
    h = hash_u32(ix, iy, seed)
    ang = h.astype(np.float64) * (2.0 * np.pi / 4294967296.0)
    return np.cos(ang), np.sin(ang)


def smoothstep(e0, e1, x):
    t = saturate((x - e0) / np.maximum(e1 - e0, 1e-12))
    return t * t * (3.0 - 2.0 * t)


def lerp(a, b, t):
    return a + (b - a) * t


def saturate(x):
    return np.clip(x, 0.0, 1.0)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def gradient_noise_2d(x, y, seed: int = 0) -> np.ndarray:
    """Perlin-style gradient noise in ~[-1, 1] (GenMath.GradientNoise2D)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = x - x0
    fy = y - y0
    u = _fade(fx)
    v = _fade(fy)

    def dot_at(dx, dy):
        gx, gy = _grad2(x0 + dx, y0 + dy, seed)
        return gx * (fx - dx) + gy * (fy - dy)

    n00 = dot_at(0, 0)
    n10 = dot_at(1, 0)
    n01 = dot_at(0, 1)
    n11 = dot_at(1, 1)
    return lerp(lerp(n00, n10, u), lerp(n01, n11, u), v) * np.sqrt(2.0)


def gradient_noise_3d(x, y, z, seed: int = 0) -> np.ndarray:
    """3-D value-gradient hybrid noise in ~[-1, 1] (GenMath.GradientNoise3D
    role: cave/vegetation fields)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    z = np.asarray(z, np.float64)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    z0 = np.floor(z).astype(np.int64)
    fx, fy, fz = x - x0, y - y0, z - z0
    u, v, w = _fade(fx), _fade(fy), _fade(fz)

    def val(dx, dy, dz):
        h = hash_u32_3(x0 + dx, y0 + dy, z0 + dz, seed)
        return h.astype(np.float64) / 2147483648.0 - 1.0

    c = lerp(
        lerp(lerp(val(0, 0, 0), val(1, 0, 0), u),
             lerp(val(0, 1, 0), val(1, 1, 0), u), v),
        lerp(lerp(val(0, 0, 1), val(1, 0, 1), u),
             lerp(val(0, 1, 1), val(1, 1, 1), u), v), w)
    return c


def fbm2d(x, y, octaves: int = 5, lacunarity: float = 2.0,
          gain: float = 0.5, seed: int = 0) -> np.ndarray:
    """Fractal Brownian motion in ~[-1, 1] (GenMath.FBM2D)."""
    total = np.zeros(np.broadcast(np.asarray(x), np.asarray(y)).shape)
    amp, freq, norm = 1.0, 1.0, 0.0
    for o in range(octaves):
        total = total + amp * gradient_noise_2d(x * freq, y * freq,
                                                seed + o * 1013)
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / max(norm, 1e-12)


def ridged_fbm2d(x, y, octaves: int = 5, lacunarity: float = 2.0,
                 gain: float = 0.5, seed: int = 0) -> np.ndarray:
    """Ridged multifractal in [0, 1] (GenMath.RidgedFBM2D)."""
    total = np.zeros(np.broadcast(np.asarray(x), np.asarray(y)).shape)
    amp, freq, norm = 1.0, 1.0, 0.0
    for o in range(octaves):
        n = gradient_noise_2d(x * freq, y * freq, seed + 7919 * o)
        r = 1.0 - np.abs(n)
        total = total + amp * r * r
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / max(norm, 1e-12)
