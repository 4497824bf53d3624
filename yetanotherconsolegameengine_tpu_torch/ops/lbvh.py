"""LBVH build on the mesh's device: Morton sort and complete-tree reduction.

Port of ``yetanotherconsolegameengine_tpu/ops/lbvh.py``, in torch on the
triangles' device (the card when the scene is moved there):

1. 30-bit Morton codes of the triangle centroids, interleaved in int64
   with masks (torch's uint32 has no shifts);
2. a stable sort of the codes (``jnp.argsort`` is stable: another order of
   equal codes gives other leaves, and with them another winner of a tie
   between two triangles of a shared edge);
3. triangles padded with zero triangles to a power-of-two leaf count
   (zero, not inf: the padded normals must stay finite), leaf boxes by
   grouped min/max, internal levels by log2(L) pairwise reductions of a
   complete binary tree;
4. one gather into the host-computed DFS order with skip links.

The result is the ``MeshBVH`` layout that ``intersect_mesh`` walks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .intersect import cross3, dot3
from .mesh_bvh import LEAF_K as TRAV_K
from .mesh_bvh import MeshBVH

LEAF_K = 4  # triangles per LBVH leaf
_BIG = 3e38


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v with two zero bits between each."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3(x, y, z) -> torch.Tensor:
    """30-bit Morton codes (int64) of [0, 1]^3 coordinates."""
    def q(v):
        return _expand_bits((torch.clamp(v, 0.0, 1.0) * 1023.0)
                            .to(torch.int64))
    return (q(x) << 2) | (q(y) << 1) | q(z)


@functools.lru_cache(maxsize=32)
def _dfs_layout(n_leaves: int):
    """DFS flattening of a complete binary tree of ``n_leaves`` (a power of
    two) leaves: numpy (heap index, skip link, leaf ordinal or -1) over the
    2 * n_leaves - 1 nodes. Heap indices are 1-based (node k has children
    2k and 2k + 1; leaves are k in [L, 2L))."""
    L = n_leaves
    N = 2 * L - 1
    heap = np.zeros(N, np.int64)
    skip = np.zeros(N, np.int32)
    leaf_ord = np.full(N, -1, np.int64)
    i = 0
    stack = [(1, N)]
    while stack:
        k, skip_to = stack.pop()
        heap[i] = k
        skip[i] = skip_to
        if k >= L:
            leaf_ord[i] = k - L
        else:
            # Node k at depth bit_length(k) - 1 owns L >> depth leaves.
            sz_left = 2 * (L >> ((k * 2).bit_length() - 1)) - 1
            stack.append((k * 2 + 1, skip_to))
            stack.append((k * 2, i + 1 + sz_left))
        i += 1
    return heap, skip, leaf_ord


def build_lbvh(a, b, c, mat) -> MeshBVH:
    """LBVH over (T, 3) vertex tensors and (T,) material ids, on their
    device."""
    a = torch.as_tensor(a, dtype=torch.float32)
    dev = a.device
    b = torch.as_tensor(b, dtype=torch.float32, device=dev)
    c = torch.as_tensor(c, dtype=torch.float32, device=dev)
    mat = torch.as_tensor(mat, dtype=torch.int32, device=dev)
    T = a.shape[0]

    tmin = torch.minimum(torch.minimum(a, b), c)
    tmax = torch.maximum(torch.maximum(a, b), c)
    cent = (tmin + tmax) * 0.5
    lo = cent.amin(0)
    ext = torch.clamp(cent.amax(0) - lo, min=1e-12)
    n01 = (cent - lo) / ext
    codes = morton3(n01[:, 0], n01[:, 1], n01[:, 2])
    order = torch.sort(codes, stable=True).indices

    L = 1
    while L * LEAF_K < T:
        L *= 2
    pad = L * LEAF_K - T
    orderp = torch.cat([order, order.new_zeros(pad)])
    valid = torch.cat([torch.ones(T, dtype=torch.bool, device=dev),
                       torch.zeros(pad, dtype=torch.bool, device=dev)])
    v3 = valid[:, None]
    # Padded triangles are zero triangles: det = 0 fails every test, and
    # their edges and normals stay finite.
    a_s = torch.where(v3, a[orderp], 0.0)
    b_s = torch.where(v3, b[orderp], 0.0)
    c_s = torch.where(v3, c[orderp], 0.0)
    m_s = torch.where(valid, mat[orderp], 0)
    tmin_s = torch.where(v3, torch.minimum(torch.minimum(a_s, b_s), c_s),
                         _BIG)
    tmax_s = torch.where(v3, torch.maximum(torch.maximum(a_s, b_s), c_s),
                         -_BIG)

    levels_min = [tmin_s.reshape(L, LEAF_K, 3).amin(1)]
    levels_max = [tmax_s.reshape(L, LEAF_K, 3).amax(1)]
    while levels_min[-1].shape[0] > 1:
        levels_min.append(levels_min[-1].reshape(-1, 2, 3).amin(1))
        levels_max.append(levels_max[-1].reshape(-1, 2, 3).amax(1))
    heap_min = torch.cat(levels_min[::-1])   # heap order, root first
    heap_max = torch.cat(levels_max[::-1])

    heap_idx, skip, leaf_ord = _dfs_layout(L)
    gather = torch.from_numpy(heap_idx - 1).to(dev)
    is_leaf = leaf_ord >= 0
    host = lambda x: torch.from_numpy(np.asarray(x, np.int32)).to(dev)

    e1 = b_s - a_s
    e2 = c_s - a_s
    nrm = cross3(e1, e2)
    nrm = nrm / torch.sqrt(torch.clamp(dot3(nrm, nrm), min=1e-20))[:, None]

    # The walk reads TRAV_K triangles from each tri_start: a zero tail keeps
    # those reads in bounds.
    def tail(x):
        return torch.cat([x, x.new_zeros((TRAV_K,) + x.shape[1:])])

    return MeshBVH(bmin=heap_min[gather], bmax=heap_max[gather],
                   skip=host(skip),
                   tri_start=host(np.where(is_leaf, leaf_ord * LEAF_K, 0)),
                   tri_count=host(np.where(is_leaf, LEAF_K, 0)),
                   a=tail(a_s), e1=tail(e1), e2=tail(e2), n=tail(nrm),
                   mat=tail(m_s))
