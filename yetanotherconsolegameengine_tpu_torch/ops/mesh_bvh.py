"""Triangle-mesh BVH: host binned-SAH build and the lockstep skip-link walk.

Port of ``yetanotherconsolegameengine_tpu/ops/mesh_bvh.py``. Nodes are
flattened in DFS pre-order with skip links, so every ray carries one
cursor: a round gathers the cursor's fused node row (AABB, skip link,
triangle count and the leaf's ``LEAF_K`` triangles inline), slab-tests it
against the ray's best t, tests a leaf's triangles with double-sided
Möller–Trumbore, and moves the cursor to the first child (an internal
node whose box is hit) or along the skip link. A finished ray's cursor is
``n_nodes``; later rounds leave it there and change nothing.

``build_mesh_bvh`` is the JAX package's numpy binned-SAH build, returning
tensors. ``MeshBVH.rows`` packs the node rows once per tree, and
``MeshBVH.heads`` / ``MeshBVH.tris`` split them for the walk kernel: a
32-byte header a node and a 64-byte record a triangle.
``intersect_mesh`` launches the walk kernel (``csrc/bvh_kernel.cu``, four
threads a ray, the headers staged in shared memory, one launch a sweep,
no host wait) for CUDA tensors and runs the plain walk for CPU tensors.
The plain walk is torch code on the rays' device: it waits on the host
only every ``CHECK_EVERY`` rounds to see whether rays are still walking,
and once at most a quarter of a batch is, it gathers the walking lanes
(``nonzero``) into a narrower batch and walks on there, as the JAX code
narrows to P/4 and P/16. Per-lane arithmetic does not depend on the other
lanes, so the result equals the uncompacted walk bit for bit, and the
kernel, which runs each lane's rounds in one lane group in the same
operation order, equals it too. The LBVH that the scene builder makes
(ops/lbvh.py) has the same layout.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..devices import resolve_impl
from ..scene._tensors import Tensors
from ..utils import profiling
from . import kernels
from .intersect import INF, Hit, _col, _lanes, _safe_div, cross3, dot3

LEAF_K = 4          # triangles per leaf (and per node row)
SAH_BINS = 16
# Rounds between host checks for rays still walking.
CHECK_EVERY = 8
# Narrow a batch of at least this many lanes once at most a quarter of it
# is still walking.
COMPACT_MIN = 1024
# The walk kernel's node header (bmin, bmax, skip, count) and triangle
# record (a, e1, e2, n, mat, 3 zeros), in f32s: 32 and 64 bytes.
HEAD_F = 8
TRI_F = 16
# Batches of a warp's rays a walk block must have at least (``grid_blocks``).
MIN_WARPS = 4
# Bytes of node headers a walk block stages at most: half of an H100 SM's
# 256 KB of L1 and shared memory, so that the other half keeps the triangle
# records in L1. Every tree the port's scenes build (up to 4,095 nodes)
# fits whole; staging a larger table whole measured slower (PERF.md).
HEAD_BUDGET = 128 * 1024

# Work counters of the walk (sweeps; the plain walk's rounds, host waits
# and compactions), for the frame profiler; ``STATS.clear()`` resets them.
STATS = profiling.register("mesh_bvh.stats", collections.Counter())


@dataclasses.dataclass(frozen=True)
class MeshBVH(Tensors):
    """Flattened BVH plus leaf-sorted SoA triangles (padded).

    Node i: internal -> first child i + 1, ``skip[i]`` jumps over the
    subtree; leaf -> ``tri_start``/``tri_count`` index the triangles.
    ``n_nodes`` is the "done" cursor."""

    bmin: torch.Tensor       # (N, 3)
    bmax: torch.Tensor       # (N, 3)
    skip: torch.Tensor       # (N,) i32
    tri_start: torch.Tensor  # (N,) i32
    tri_count: torch.Tensor  # (N,) i32, 0 for internal nodes
    a: torch.Tensor          # (T, 3)
    e1: torch.Tensor         # (T, 3)
    e2: torch.Tensor         # (T, 3)
    n: torch.Tensor          # (T, 3) unit geometric normals
    mat: torch.Tensor        # (T,) i32

    @property
    def n_nodes(self) -> int:
        return self.bmin.shape[0]

    @functools.cached_property
    def rows(self) -> torch.Tensor:
        """``node_rows`` of this tree, packed at first use and kept: both
        walks read them, and a rebuilt or moved tree is a new ``MeshBVH``
        with rows of its own."""
        return node_rows(self)

    @functools.cached_property
    def heads(self) -> torch.Tensor:
        """(N, HEAD_F) f32 node headers for the walk kernel, ``rows[:, :8]``
        packed at first use and kept, like ``rows``."""
        return self.rows[:, :HEAD_F].contiguous()

    @functools.cached_property
    def tris(self) -> torch.Tensor:
        """(N, LEAF_K, TRI_F) f32 triangle records for the walk kernel: each
        node's ``LEAF_K`` triangles of ``rows``, zero-padded to 64 bytes,
        packed at first use and kept, like ``rows``."""
        tri = self.rows[:, 8:].view(-1, LEAF_K, 13)
        return torch.nn.functional.pad(tri, (0, TRI_F - 13)).contiguous()

    @property
    def n_tris(self) -> int:
        return self.a.shape[0]


def _pad_to(arr: np.ndarray, n: int) -> np.ndarray:
    pad = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def build_mesh_bvh(a, b, c, mat) -> MeshBVH:
    """Binned-SAH build over (T, 3) vertex arrays, on the host."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    c = np.asarray(c, np.float32)
    mat = np.asarray(mat, np.int32)
    T = a.shape[0]
    tmin = np.minimum(np.minimum(a, b), c)
    tmax = np.maximum(np.maximum(a, b), c)
    cent = (tmin + tmax) * 0.5

    nodes = []  # dicts: bmin, bmax, left, right, start, count, axis
    order = np.arange(T)

    def make_node(lo, hi):
        nodes.append(dict(bmin=None, bmax=None, left=-1, right=-1,
                          start=lo, count=hi - lo, axis=0))
        return len(nodes) - 1

    root = make_node(0, T)
    stack = [root]
    while stack:
        ni = stack.pop()
        nd = nodes[ni]
        lo, hi = nd["start"], nd["start"] + nd["count"]
        idx = order[lo:hi]
        nd["bmin"], nd["bmax"] = tmin[idx].min(axis=0), tmax[idx].max(axis=0)
        count = hi - lo
        if count <= LEAF_K:
            continue
        cb_min = cent[idx].min(axis=0)
        ext = cent[idx].max(axis=0) - cb_min
        best = (np.inf, -1, -1)  # (cost, axis, split_bin)
        bins_of = {}
        for ax in range(3):
            if ext[ax] <= 1e-12:
                continue
            scale = SAH_BINS * (1.0 - 1e-6) / ext[ax]
            bins = np.minimum(((cent[idx, ax] - cb_min[ax]) * scale)
                              .astype(np.int64), SAH_BINS - 1)
            bins_of[ax] = bins
            cnt = np.bincount(bins, minlength=SAH_BINS)
            bin_min = np.full((SAH_BINS, 3), np.inf, np.float32)
            bin_max = np.full((SAH_BINS, 3), -np.inf, np.float32)
            for k in range(SAH_BINS):
                sel = bins == k
                if sel.any():
                    bin_min[k] = tmin[idx[sel]].min(axis=0)
                    bin_max[k] = tmax[idx[sel]].max(axis=0)

            def area_sweep(bm, bx, cn):
                run_min = np.minimum.accumulate(bm, axis=0)
                run_max = np.maximum.accumulate(bx, axis=0)
                d = np.maximum(run_max - run_min, 0.0)
                area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
                return area, np.cumsum(cn)

            area_l, cnt_l = area_sweep(bin_min, bin_max, cnt)
            area_r, cnt_r = area_sweep(bin_min[::-1], bin_max[::-1], cnt[::-1])
            area_r, cnt_r = area_r[::-1], cnt_r[::-1]
            for k in range(SAH_BINS - 1):
                nl, nr = cnt_l[k], cnt_r[k + 1]
                if nl == 0 or nr == 0:
                    continue
                cost = area_l[k] * nl + area_r[k + 1] * nr
                if cost < best[0]:
                    best = (cost, ax, k)
        if best[1] < 0:
            # Degenerate: median split on the longest axis.
            ax = int(np.argmax(ext))
            sort = np.argsort(cent[idx, ax], kind="stable")
            order[lo:hi] = idx[sort]
            mid = lo + count // 2
        else:
            ax, k = best[1], best[2]
            go_left = bins_of[ax] <= k
            order[lo:hi] = np.concatenate([idx[go_left], idx[~go_left]])
            mid = lo + int(go_left.sum())
        nd["axis"] = ax
        li = make_node(lo, mid)
        ri = make_node(mid, hi)
        nd["left"], nd["right"] = li, ri
        nd["count"] = 0
        stack.append(ri)
        stack.append(li)

    # Flatten in DFS pre-order with skip links.
    N = len(nodes)
    f_bmin = np.zeros((N, 3), np.float32)
    f_bmax = np.zeros((N, 3), np.float32)
    f_skip = np.zeros(N, np.int32)
    f_start = np.zeros(N, np.int32)
    f_count = np.zeros(N, np.int32)
    i = 0
    stack2 = [(root, N)]
    while stack2:
        ni, skip_to = stack2.pop()
        nd = nodes[ni]
        f_bmin[i], f_bmax[i] = nd["bmin"], nd["bmax"]
        f_skip[i] = skip_to
        if nd["left"] < 0:
            f_start[i] = nd["start"]
            f_count[i] = nd["count"]
        else:
            # The left child follows at i + 1 and skips to the right child.
            right_at = i + 1 + _subtree_size(nodes, nd["left"])
            stack2.append((nd["right"], skip_to))
            stack2.append((nd["left"], right_at))
        i += 1

    a_s, b_s, c_s, m_s = a[order], b[order], c[order], mat[order]
    e1 = b_s - a_s
    e2 = c_s - a_s
    nrm = np.cross(e1, e2)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    Tp = T + LEAF_K  # the tail keeps start..start+K gathers in bounds
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return MeshBVH(bmin=t(f_bmin), bmax=t(f_bmax), skip=t(f_skip),
                   tri_start=t(f_start), tri_count=t(f_count),
                   a=t(_pad_to(a_s, Tp)), e1=t(_pad_to(e1, Tp)),
                   e2=t(_pad_to(e2, Tp)), n=t(_pad_to(nrm, Tp)),
                   mat=t(_pad_to(m_s, Tp)))


def _subtree_size(nodes, ni) -> int:
    total = 0
    st = [ni]
    while st:
        nd = nodes[st.pop()]
        total += 1
        if nd["left"] >= 0:
            st.append(nd["left"])
            st.append(nd["right"])
    return total


def node_rows(bvh: MeshBVH) -> torch.Tensor:
    """(N, 8 + 13 * LEAF_K) f32 node rows: bmin, bmax, skip, count, then
    the leaf's ``LEAF_K`` triangles inline (a, e1, e2, n, mat each);
    internal nodes carry triangles that their zero count masks."""
    head = torch.cat([bvh.bmin, bvh.bmax, bvh.skip.float()[:, None],
                      bvh.tri_count.float()[:, None]], 1)
    tri_rows = torch.cat([bvh.a, bvh.e1, bvh.e2, bvh.n,
                          bvh.mat.float()[:, None]], 1)
    k = torch.arange(LEAF_K, device=head.device)
    ti = bvh.tri_start.long()[:, None] + k[None]
    return torch.cat([head, tri_rows[ti].reshape(-1, LEAF_K * 13)], 1)


def _walk(rows: torch.Tensor, st: dict, n_nodes: int,
          work: dict = None) -> None:
    """One lockstep round on the lanes of ``st``, in place. ``work``, when
    given, sums the round's node visits and triangle tests and marks the
    rows it reads (``walk_work``)."""
    node, t, o, d, inv, t_lo = (st[k] for k in ("node", "t", "o", "d",
                                                "inv", "tlo"))
    active = node < n_nodes
    row = rows[torch.clamp(node, max=n_nodes - 1)]
    ta = (row[:, 0:3] - o) * inv
    tb = (row[:, 3:6] - o) * inv
    t0 = torch.minimum(ta, tb).amax(1)
    t1 = torch.maximum(ta, tb).amin(1)
    box_hit = active & (t0 <= t1) & (t1 >= t_lo) & (t0 <= t)
    count = row[:, 7]
    is_leaf = count > 0.0
    tri = row[:, 8:].reshape(-1, LEAF_K, 13)
    dd = d[:, None, :].expand(-1, LEAF_K, -1)
    e1, e2 = tri[..., 3:6], tri[..., 6:9]
    h = cross3(dd, e2)
    det = dot3(e1, h)
    inv_det = _safe_div(torch.ones_like(det), det)
    s = o[:, None, :] - tri[..., 0:3]
    u = dot3(s, h) * inv_det
    q = cross3(s, e1)
    v = dot3(dd, q) * inv_det
    tt = dot3(e2, q) * inv_det
    k = torch.arange(LEAF_K, device=o.device, dtype=torch.float32)
    in_leaf = (box_hit & is_leaf)[:, None] & (k[None] < count[:, None])
    valid = (in_leaf & (det.abs() >= 1e-8) & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0) & (tt >= t_lo[:, None])
             & (tt < t[:, None]))
    if work is not None:
        work["visits"] += active
        work["tri_tests"] += in_leaf.sum(1)
        work["rows"][node[active]] = True
    tt = torch.where(valid, tt, INF)
    # The first of equal minima over the K in-row triangles.
    kk = tt.argmin(1, keepdim=True)
    t_leaf = tt.gather(1, kk)[:, 0]
    better = t_leaf < t
    win = tri.gather(1, kk[..., None].expand(-1, 1, 13))[:, 0]
    st["t"] = torch.where(better, t_leaf, t)
    st["wn"] = torch.where(better[:, None], win[:, 9:12], st["wn"])
    st["wm"] = torch.where(better, win[:, 12], st["wm"])
    st["u"] = torch.where(better, u.gather(1, kk)[:, 0], st["u"])
    st["v"] = torch.where(better, v.gather(1, kk)[:, 0], st["v"])
    nxt = torch.where(box_hit & ~is_leaf, node + 1, row[:, 6].long())
    st["node"] = torch.where(active, nxt, node)


_OUT = ("node", "t", "wn", "wm", "u", "v")


def _start(o, d, tmin, tmax) -> dict:
    """The plain walk's lanes before the first round."""
    P = o.shape[0]
    z = torch.zeros(P, device=o.device)
    return dict(node=torch.zeros(P, dtype=torch.int64, device=o.device),
                t=_col(tmax, o)[:, 0], wn=torch.zeros((P, 3), device=o.device),
                wm=z, u=z, v=z, o=o, d=d,
                inv=_safe_div(torch.ones_like(d), d), tlo=_col(tmin, o)[:, 0])


def intersect_mesh(bvh: MeshBVH, o, d, tmin, tmax, compact: bool = True,
                   impl=None) -> Hit:
    """Nearest hit over the BVH's triangles. o/d: (P, 3); tmin/tmax scalar
    or (P,). Double-sided, the normal flipped against the ray; a hit needs
    ``tmin <= t < tmax``, and a later leaf only wins when strictly nearer.
    ``impl``: "kernel" (the walk kernel, one launch), "plain" (the torch
    walk), None: from the rays' device. ``compact=False`` walks every lane
    of the plain walk to the end (the reference the compacted walk
    equals)."""
    impl = resolve_impl(impl, o.device)
    STATS["sweeps"] += 1
    if impl == "kernel":
        return walk(bvh.heads, bvh.tris, o.contiguous(), d.contiguous(),
                    _lanes(tmin, o), _lanes(tmax, o))
    n_nodes = bvh.n_nodes
    rows = bvh.rows
    full = _start(o, d, tmin, tmax)
    t_hi = full["t"]
    cur, lanes = full, None
    while True:
        for _ in range(CHECK_EVERY):
            _walk(rows, cur, n_nodes)
        STATS["rounds"] += CHECK_EVERY
        STATS["waits"] += 1
        walking = cur["node"] < n_nodes
        n_walking = profiling.sync("mesh_bvh.walking", int, walking.sum())
        if n_walking == 0:
            break
        width = cur["node"].shape[0]
        if compact and width >= COMPACT_MIN and 4 * n_walking <= width:
            keep = profiling.sync("mesh_bvh.compact", torch.nonzero,
                                  walking)[:, 0]
            if lanes is not None:
                _write_back(full, cur, lanes)
            cur = {k: x[keep] for k, x in cur.items()}
            lanes = keep if lanes is None else lanes[keep]
            STATS["compactions"] += 1
    if lanes is not None:
        _write_back(full, cur, lanes)
    hit = full["t"] < t_hi
    nrm = full["wn"]
    nrm = torch.where((dot3(nrm, d) >= 0.0)[:, None], -nrm, nrm)
    return Hit(t=torch.where(hit, full["t"], INF), n=nrm, u=full["u"],
               v=full["v"], mat=full["wm"].to(torch.int32), hit=hit)


def _write_back(full: dict, cur: dict, lanes) -> None:
    for k in _OUT:
        full[k] = full[k].index_copy(0, lanes, cur[k])


def shared_nodes(n_nodes: int, budget: int) -> int:
    """Headers the walk kernel stages in shared memory: all of them when
    they fit in ``budget`` bytes, else the first that do, in DFS pre-order
    (the kernel reads the rest through L1)."""
    return min(n_nodes, budget // (HEAD_F * 4))


def grid_blocks(n_rays: int, sms: int, blocks_per_sm: int,
                warp_rays: int) -> int:
    """Blocks of a walk launch: as many as the card holds at once, so each
    block stages the headers once and its warps loop over batches of
    ``warp_rays`` rays; fewer for a small sweep, so that each block has
    ``MIN_WARPS`` batches or more to pay for its staging."""
    batches = -(-n_rays // warp_rays)
    return max(1, min(sms * blocks_per_sm, -(-batches // MIN_WARPS)))


@functools.lru_cache(maxsize=None)
def _limits(lib, device: int, smem: int) -> tuple:
    """``yacge_bvh_limits`` of ``lib`` on CUDA device ``device``: (opt-in
    shared bytes a block, SMs, blocks an SM at ``smem``, threads a block,
    lanes a ray)."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = lib.yacge_bvh_limits(smem, out)
    kernels.check(err, "BVH walk kernel occupancy query")
    return tuple(out)


def walk_shape(n_nodes: int, n_rays: int, device, lib=None) -> dict:
    """The walk kernel's launch on ``device`` (``lib``: the kernel library,
    ``kernels.library()`` by default): headers staged (``n_shared``) and
    their bytes, blocks, blocks an SM, and what they come from: the
    staging budget (``HEAD_BUDGET`` or the block's opt-in shared memory,
    the smaller), the SMs, threads a block and lanes a ray."""
    lib = kernels.library() if lib is None else lib
    dev = torch.device(device).index
    dev = torch.cuda.current_device() if dev is None else dev
    optin, sms = _limits(lib, dev, 0)[:2]
    budget = min(optin, HEAD_BUDGET)
    n_shared = shared_nodes(n_nodes, budget)
    smem = n_shared * HEAD_F * 4
    _, _, per_sm, threads, lanes = _limits(lib, dev, smem)
    return {"n_shared": n_shared, "shared_bytes": smem,
            "blocks": grid_blocks(n_rays, sms, per_sm, 32 // lanes),
            "blocks_per_sm": per_sm, "sms": sms, "budget": budget,
            "threads": threads, "lanes": lanes}


def walk(heads, tris, o, d, tmin, tmax) -> Hit:
    """Launch the walk kernel: ``heads`` (N, HEAD_F) and ``tris`` (N,
    LEAF_K, TRI_F) f32 (``MeshBVH.heads`` / ``.tris``), each starting on a
    16-byte boundary, o/d (P, 3) f32, tmin/tmax (P,) f32, all contiguous
    on one CUDA device. Returns ``intersect_mesh``'s ``Hit``; an empty
    batch launches nothing. The launch shape is ``walk_shape``'s."""
    P = o.shape[0]
    kernels.require(heads, "heads", torch.float32)
    if heads.dim() != 2 or heads.shape[1] != HEAD_F:
        raise ValueError(f"heads must be (N, {HEAD_F}), got "
                         f"{tuple(heads.shape)}")
    N = heads.shape[0]
    kernels.require(tris, "tris", torch.float32, (N, LEAF_K, TRI_F))
    for name, x in (("heads", heads), ("tris", tris)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    for name, x, shape in (("o", o, (P, 3)), ("d", d, (P, 3)),
                           ("tmin", tmin, (P,)), ("tmax", tmax, (P,))):
        kernels.require(x, name, torch.float32, shape)
    dev = o.device
    t = torch.empty(P, device=dev)
    n = torch.empty((P, 3), device=dev)
    u = torch.empty(P, device=dev)
    v = torch.empty(P, device=dev)
    mat = torch.empty(P, dtype=torch.int32, device=dev)
    hit = torch.empty(P, dtype=torch.bool, device=dev)
    if P:
        shape = walk_shape(N, P, dev)
        err = kernels.library().yacge_bvh_launch(
            heads.data_ptr(), tris.data_ptr(), N, shape["n_shared"],
            shape["blocks"], o.data_ptr(), d.data_ptr(), tmin.data_ptr(),
            tmax.data_ptr(), P, t.data_ptr(), n.data_ptr(), u.data_ptr(),
            v.data_ptr(), mat.data_ptr(), hit.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        kernels.check(err, "BVH walk kernel")
        kernels.LAUNCHES["bvh"] += 1
    return Hit(t=t, n=n, u=u, v=v, mat=mat, hit=hit)


def walk_counts(bvh: MeshBVH, o, d, tmin, tmax):
    """Run the plain walk uncompacted to its end, counting: (a dict of the
    (P,) node visits and triangle tests of each ray and the (N,) rows read,
    the lockstep rounds)."""
    n_nodes = bvh.n_nodes
    st = _start(o, d, tmin, tmax)
    lanes = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    work = dict(visits=lanes, tri_tests=lanes.clone(),
                rows=torch.zeros(n_nodes, dtype=torch.bool, device=o.device))
    rounds = 0
    while bool((st["node"] < n_nodes).any()):
        _walk(bvh.rows, st, n_nodes, work)
        rounds += 1
    return work, rounds


def walk_work(bvh: MeshBVH, o, d, tmin, tmax) -> dict:
    """The work these rays' walks need (``walk_counts``): node visits
    (active lanes summed over rounds) and the most of any ray, triangle
    tests (the count triangles of each leaf whose box is hit), the distinct
    rows read; with the lockstep rounds and the share of a warp's visit
    slots that visit (``kernels.warp_efficiency``)."""
    work, rounds = walk_counts(bvh, o, d, tmin, tmax)
    v = work["visits"]
    return {"visits": int(v.sum()),
            "max_visits": int(v.max()) if v.numel() else 0,
            "tri_tests": int(work["tri_tests"].sum()),
            "rows": int(work["rows"].sum()), "rounds": rounds,
            "warp_efficiency": kernels.warp_efficiency(v)}
