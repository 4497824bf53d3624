"""The cluster-sweep kernel's wrapper and its plain version (K3).

Port of ``yetanotherconsolegameengine_tpu/ops/mesh_clusters.py``
``_trace_kernel`` / ``_run_kernel``. Given per-tile candidate lists
(cluster ids in near-to-far order of their entry distance), the cluster
blocks and the binned rays, return per ray the winning triangle and its t,
and per tile the number of list entries tested. The CUDA source is
``csrc/cluster_kernel.cu``; its header comment states the arithmetic, the
winner rule and the split schedule.

Inputs (all on one device):
  lens    (n_tiles,) i32        list lengths
  ids     (n_tiles, C) i32      cluster ids, candidates first
  entry_t (n_tiles, C) f32      their entry distances, ascending
  gmat    (C, 12, kc) f32       Woop blocks (ops/mesh_clusters.py)
  rays    (n_tiles * 256, 8) f32  o, d, tmin, tinit (-inf: not taking part)
Outputs: t (P,) f32 (3e38 without a hit), win (P,) i32 flat triangle id
cluster * kc + k (-1 without a hit), steps (n_tiles,) i32.

The winner is the minimum of (key(t), list position e, k), key(t) being t
with the low ``qmask`` bits cleared: of equal keys the earlier list entry
wins, and within an entry the lower triangle slot. That is the JAX
kernel's rule (it visits the list in order, keeps a strictly smaller key
across visits, and within a visit takes the lowest lane among equal
keys); shared edges of coplanar quads of different materials, as the
streamed world meshes them, resolve by it.

``trace_tiles_plain`` defines the function: it walks each tile's list in
order. The kernel cuts the lists into pieces that run in parallel and
combines them through one 64-bit word per ray (``pack_words``: the
order-preserving image of key(t) above the list index e * kc + k), so in
nearest mode it returns the same t and winners, bit for bit; ``steps``
then counts entries tested over all pieces and may exceed the serial
walk's. In any-hit mode (every hit ends the ray) both give the same hit
mask, but the kernel may return another blocker. ``unpack_words`` is the
kernel's epilogue.

``trace_tiles`` launches the kernel for CUDA tensors and runs
``trace_tiles_plain`` for CPU tensors, where no kernel exists.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import kernels

TILE = 256         # rays per tile
NO_HIT_T = 3.0e38
# The kernel's split schedule (kPiece, kRaysPerBlock in
# csrc/cluster_kernel.cu): list entries and rays of a tile per work item.
PIECE = 2
RAYS_PER_BLOCK = 128
_TOP = 1 << 63


def key_of(t: torch.Tensor, qmask: int) -> torch.Tensor:
    """The winner key: t's bits with the low ``qmask`` bits cleared."""
    if qmask == 0:
        return t
    return (t.view(torch.int32) & ~qmask).view(torch.float32)


def order_key(key: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving uint32 image of f32 keys, as int64:
    negative keys bit-inverted, others with the sign bit set; -0 maps
    with +0."""
    key = torch.where(key == 0, torch.zeros_like(key), key)
    b = key.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= 1 << 31, b ^ 0xFFFFFFFF, b | 1 << 31)


def pack_words(t, idx, rays, qmask: int) -> torch.Tensor:
    """The kernel's per-ray words for a result (t, idx), idx the winner's
    list index e * kc + k (-1 without a hit): (order image of key(t)) << 32
    | idx for a hit, (image of key(tinit)) << 32 | 0 without one. Returned
    as int64 with the top bit flipped, so signed order is the kernel's
    unsigned order and ``torch.minimum`` combines."""
    key = torch.where(idx >= 0, key_of(t, qmask),
                      key_of(rays[:, 7].contiguous(), qmask))
    low = torch.clamp(idx, min=0).to(torch.int64)
    return ((order_key(key) << 32) | low) ^ _TOP


def winner_t(gmat, rays, win) -> torch.Tensor:
    """Each winner's t from its W rows in the sweep's operation order
    (NO_HIT_T where win < 0): the kernel's epilogue."""
    kc = gmat.shape[2]
    flat = torch.clamp(win, min=0).long()
    w = gmat[flat // kc, 8:12, flat % kc]                  # (P, 4)
    r = rays
    ow = ((w[:, 0] * r[:, 0] + w[:, 1] * r[:, 1]) + w[:, 2] * r[:, 2]) \
        + w[:, 3]
    dw = (w[:, 0] * r[:, 3] + w[:, 1] * r[:, 4]) + w[:, 2] * r[:, 5]
    return torch.where(win >= 0, -ow / dw, NO_HIT_T)


def unpack_words(words, ids, gmat, rays, qmask: int):
    """Combined words -> (t, win), as the kernel's epilogue reads them: a
    word below the ray's starting word is a hit, and its list index maps
    through the ray's tile list ``ids`` to the flat triangle id."""
    hit = words < pack_words(rays[:, 7], torch.full_like(words, -1,
                                                         dtype=torch.int32),
                             rays, qmask)
    kc = gmat.shape[2]
    idx = words & 0xFFFFFFFF
    tile = torch.arange(words.shape[0], device=words.device) // TILE
    cid = ids[tile, torch.where(hit, idx // kc, 0)].to(torch.int64)
    win = torch.where(hit, cid * kc + idx % kc, -1).to(torch.int32)
    return winner_t(gmat, rays, win), win


def trace_tiles_plain(lens, ids, entry_t, gmat, rays, any_hit: bool,
                      qmask: int):
    """The function in PyTorch: list position by list position, every
    tile's entry block against every ray of the tile at once, a tile ending
    once no ray of it can improve on its next entry (in any-hit mode: once
    every ray that can has a hit). A later entry wins only with a strictly
    smaller key. Syncs with the host once per list position to stop when
    no tile is left."""
    n_tiles, C = ids.shape
    kc = gmat.shape[2]
    dev = rays.device
    r = rays.view(n_tiles, TILE, 8)
    ox, oy, oz = (r[..., i, None] for i in range(3))
    dx, dy, dz = (r[..., i, None] for i in range(3, 6))
    tmin = r[..., 6, None]
    best_key = key_of(r[..., 7].contiguous(), qmask)
    best_t = torch.full((n_tiles, TILE), NO_HIT_T, device=dev)
    best_id = torch.full((n_tiles, TILE), -1, dtype=torch.int32, device=dev)
    steps = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    alive = torch.ones(n_tiles, dtype=torch.bool, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    k_iota = torch.arange(kc, device=dev)
    for e in range(C):
        bound = (torch.where(best_id >= 0, -inf, best_key) if any_hit
                 else best_key)
        want = key_of(entry_t[:, e].contiguous(), qmask)[:, None] <= bound
        alive = alive & want.any(1)
        live = alive & (e < lens)
        if not profiling.sync("cluster_kernel.live", bool, live.any()):
            break
        cid = ids[:, e]
        g = gmat[cid.long()][:, :, None, :]           # (n_tiles, 12, 1, kc)

        def row(i):
            return g[:, i]

        ou = ((row(0) * ox + row(1) * oy) + row(2) * oz) + row(3)
        du = (row(0) * dx + row(1) * dy) + row(2) * dz
        ov = ((row(4) * ox + row(5) * oy) + row(6) * oz) + row(7)
        dv = (row(4) * dx + row(5) * dy) + row(6) * dz
        ow = ((row(8) * ox + row(9) * oy) + row(10) * oz) + row(11)
        dw = (row(8) * dx + row(9) * dy) + row(10) * dz
        t = -ow / dw
        u = ou + t * du
        v = ov + t * dv
        valid = ((u >= -1e-3) & (v >= -1e-3) & ((1.0 - u) - v >= -1e-3)
                 & (t > tmin) & live[:, None, None])
        key = torch.where(valid, key_of(t, qmask), inf)
        kmin = key.amin(-1)                               # (n_tiles, T)
        k = torch.where(key == kmin[..., None], k_iota, kc).amin(-1)
        flat = cid[:, None] * kc + k.to(torch.int32)
        better = kmin < best_key     # ties stay with the earlier entry
        best_key = torch.where(better, kmin, best_key)
        best_t = torch.where(better, t.gather(-1, k[..., None])[..., 0],
                             best_t)
        best_id = torch.where(better, flat, best_id)
        steps = steps + live.to(torch.int32)
    return best_t.reshape(-1), best_id.reshape(-1), steps


def trace_tiles(lens, ids, entry_t, gmat, rays, any_hit: bool, qmask: int):
    """Launch the kernel on CUDA tensors (the plain version for CPU
    tensors). Returns what ``trace_tiles_plain`` returns."""
    if rays.device.type == "cpu":
        return trace_tiles_plain(lens, ids, entry_t, gmat, rays, any_hit,
                                 qmask)
    n_tiles, C = ids.shape
    kc = gmat.shape[2]
    kernels.require(lens, "lens", torch.int32, (n_tiles,))
    kernels.require(ids, "ids", torch.int32, (n_tiles, C))
    kernels.require(entry_t, "entry_t", torch.float32, (n_tiles, C))
    kernels.require(gmat, "gmat", torch.float32, (C, 12, kc))
    kernels.require(rays, "rays", torch.float32, (n_tiles * TILE, 8))
    if kc % 4 or 2 * 12 * kc * 4 > 200 * 1024:
        raise ValueError(f"cluster width {kc} must be a multiple of 4 and "
                         "at most 2132")
    dev = rays.device
    P = n_tiles * TILE
    best = torch.empty(P, dtype=torch.int64, device=dev)   # u64 words
    out_t = torch.empty(P, dtype=torch.float32, device=dev)
    out_win = torch.empty(P, dtype=torch.int32, device=dev)
    steps = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    err = kernels.library().yacge_cluster_launch(
        lens.data_ptr(), ids.data_ptr(), entry_t.data_ptr(), gmat.data_ptr(),
        rays.data_ptr(), n_tiles, C, kc, int(any_hit), qmask, best.data_ptr(),
        out_t.data_ptr(), out_win.data_ptr(), steps.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "cluster kernel")
    kernels.LAUNCHES["clusters"] += 1
    return out_t, out_win, steps
