"""The BVH walk and voxel DDA kernels' surroundings on the CPU (the kernels
themselves run only on the card: tests/test_torch_cuda.py).

``intersect_mesh`` and ``intersect_voxels`` take their plain loops for CPU
tensors and refuse ``impl="kernel"`` there; ``intersect_scene`` hands its
``impl`` to both sweeps; a tree's packed node rows, headers and triangle
records are built once and hold ``node_rows``' values; the walk kernel's
launch arithmetic (headers staged, blocks) and the DDA kernel's grid
constants are checked. A numpy model of each kernel's thread (one ray's
whole loop, float32 scalar arithmetic in the kernel's operation order)
equals the plain version bit for bit and the JAX package's function within
tests/test_torch_mesh_bvh.py's and tests/test_torch_dda.py's tolerances,
and counts the work that ``walk_work`` and ``march_work`` report; a model
of the walk kernel's lane group (four lanes a ray, each with its own
registers, the shuffle reduction over (t, k), headers read from a staged
copy and the tree's table) equals the plain walk bit for bit."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yetanotherconsolegameengine_tpu.ops import dda as jdda
from yetanotherconsolegameengine_tpu.ops import lbvh as jlbvh
from yetanotherconsolegameengine_tpu.ops import mesh_bvh as jbvh
from yetanotherconsolegameengine_tpu.scene import mesh_loader as jml
from chip_smoke import STRESS_H, dda_stress_cases
from yetanotherconsolegameengine_tpu_torch.core.camera import (
    make_jittered_rays, ray_params)
from yetanotherconsolegameengine_tpu_torch.ops import (dda, intersect,
                                                       kernels, lbvh,
                                                       mesh_bvh)
from yetanotherconsolegameengine_tpu_torch.ops.intersect import INF
from yetanotherconsolegameengine_tpu_torch.scene.builders import SCENE_BUILDERS

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

CSRC = Path(mesh_bvh.__file__).resolve().parent / "csrc"
F = np.float32
KINF = F(3e38)


def knot():
    tris = jml.make_knot(seg_u=48, seg_v=6)
    return (tris[:, 0], tris[:, 1], tris[:, 2],
            (np.arange(len(tris)) % 3).astype(np.int32))


def rays_at(aim, n, seed, spread=3.0):
    """Rays from Gaussian origins toward jittered points of ``aim``."""
    rs = np.random.RandomState(seed)
    o = (spread * rs.randn(n, 3)).astype(np.float32)
    d = aim[rs.randint(0, len(aim), n)] + 0.2 * rs.randn(n, 3) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def primary(scene, w, h, frame=3):
    params = ray_params(scene.default_pose, w, h, frame)
    return tuple(x.reshape(-1, 3).contiguous() for x in make_jittered_rays(
        None, w, h, frame, params=params))


def cave():
    return SCENE_BUILDERS["voxel_cave"]()


# ---- the numpy models of one kernel thread ---------------------------------

def _min(a, b):      # torch.minimum
    return a if a != a else (b if b != b else (b if b < a else a))


def _max(a, b):      # torch.maximum
    return a if a != a else (b if b != b else (b if b > a else a))


def _inv(x):         # _safe_div(1, x)
    return F(1) / ((F(-1e-12) if x < 0 else F(1e-12)) if abs(x) < F(1e-12)
                   else x)


def _mt(tri, o, d):
    """Double-sided Moller-Trumbore on one triangle's 13 floats."""
    a, e1, e2 = tri[0:3], tri[3:6], tri[6:9]
    h = (d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
         d[0] * e2[1] - d[1] * e2[0])
    det = (e1[0] * h[0] + e1[1] * h[1]) + e1[2] * h[2]
    inv_det = _inv(det)
    s = (o[0] - a[0], o[1] - a[1], o[2] - a[2])
    u = ((s[0] * h[0] + s[1] * h[1]) + s[2] * h[2]) * inv_det
    q = (s[1] * e1[2] - s[2] * e1[1], s[2] * e1[0] - s[0] * e1[2],
         s[0] * e1[1] - s[1] * e1[0])
    v = ((d[0] * q[0] + d[1] * q[1]) + d[2] * q[2]) * inv_det
    tt = ((e2[0] * q[0] + e2[1] * q[1]) + e2[2] * q[2]) * inv_det
    ok = (abs(det) >= F(1e-8) and u >= 0 and u <= 1 and v >= 0
          and u + v <= 1)
    return tt, u, v, ok


def walk_thread(rows, o, d, t_lo, t_hi):
    """csrc/bvh_kernel.cu's thread: (t, n, u, v, mat, hit, visits)."""
    inv = [_inv(x) for x in d]
    t, n, wm, bu, bv = t_hi, [F(0)] * 3, F(0), F(0), F(0)
    node = visits = 0
    while node < rows.shape[0] and visits < rows.shape[0]:
        visits += 1
        r = rows[node]
        ta = [(r[a] - o[a]) * inv[a] for a in range(3)]
        tb = [(r[3 + a] - o[a]) * inv[a] for a in range(3)]
        t0 = _max(_max(_min(ta[0], tb[0]), _min(ta[1], tb[1])),
                  _min(ta[2], tb[2]))
        t1 = _min(_min(_max(ta[0], tb[0]), _max(ta[1], tb[1])),
                  _max(ta[2], tb[2]))
        box = t0 <= t1 and t1 >= t_lo and t0 <= t
        leaf = r[7] > 0
        tris = [r[8 + 13 * k:21 + 13 * k] for k in range(4)]
        if box and leaf:
            best, kk, cu, cv = KINF, 0, F(0), F(0)
            for k in range(4):
                tt, u, v, ok = _mt(tris[k], o, d)
                tk = tt if (F(k) < r[7] and ok and tt >= t_lo
                            and tt < t) else KINF
                if k == 0 or tk < best:
                    best, kk, cu, cv = tk, k, u, v
            if best < t:
                t, bu, bv = best, cu, cv
                n, wm = list(tris[kk][9:12]), tris[kk][12]
        elif KINF < t:
            _, bu, bv, _ = _mt(tris[0], o, d)
            t, n, wm = KINF, list(tris[0][9:12]), tris[0][12]
        node = node + 1 if box and not leaf else int(r[6])
    hit = bool(t < t_hi)
    if (n[0] * d[0] + n[1] * d[1]) + n[2] * d[2] >= 0:
        n = [-x for x in n]
    return t if hit else KINF, n, bu, bv, int(wm), hit, visits


def _box(h, o, inv, t_lo, t):
    """The slab test of header ``h`` against [t_lo, t]."""
    ta = [(h[a] - o[a]) * inv[a] for a in range(3)]
    tb = [(h[3 + a] - o[a]) * inv[a] for a in range(3)]
    t0 = _max(_max(_min(ta[0], tb[0]), _min(ta[1], tb[1])), _min(ta[2], tb[2]))
    t1 = _min(_min(_max(ta[0], tb[0]), _max(ta[1], tb[1])), _max(ta[2], tb[2]))
    return bool(t0 <= t1 and t1 >= t_lo and t0 <= t)


# Threads a ray in csrc/bvh_kernel.cu (its kLanes).
LANES = 4


def walk_group(heads, staged, tris, o, d, t_lo, t_hi):
    """csrc/bvh_kernel.cu's lane group on one ray: ``LANES`` lanes, each
    with its own registers. Headers of nodes below ``len(staged)`` come
    from ``staged`` (the block's shared-memory copy), the rest from
    ``heads``. At a leaf whose box is hit, lane l tests triangles l,
    l + LANES, ... (a serial first-of-equal-minima scan), the lanes
    exchange (tk, k) by xor shuffles, and the winner's u, v, n and mat come
    from its lane. Returns (t, n, u, v, mat, hit, visits, headers read
    from ``heads``); every lane ends in the same state."""
    inv = [_inv(x) for x in d]
    L = range(LANES)
    reg = [dict(t=t_hi, n=(F(0),) * 3, wm=F(0), u=F(0), v=F(0)) for _ in L]
    node = visits = from_table = 0
    while node < len(heads) and visits < len(heads):
        visits += 1
        if node < len(staged):
            h = staged[node]
        else:
            h = heads[node]
            from_table += 1
        box = [_box(h, o, inv, t_lo, reg[k]["t"]) for k in L]
        assert len(set(box)) == 1      # the lanes agree without exchange
        leaf = h[7] > 0
        if box[0] and leaf:
            own = []                   # each lane's (best, k, u, v, n, mat)
            for k in L:
                best = None
                for j in range(mesh_bvh.LEAF_K // LANES):
                    kt = k + j * LANES
                    rec = tris[node, kt]
                    tt, u, v, ok = _mt(rec, o, d)
                    tk = tt if (F(kt) < h[7] and ok and tt >= t_lo
                                and tt < reg[k]["t"]) else KINF
                    if j == 0 or tk < best[0]:
                        best = (tk, kt, u, v, tuple(rec[9:12]), rec[12])
                own.append(best)
            key = [b[:2] for b in own]
            off = 1
            while off < LANES:         # __shfl_xor_sync over the group
                key = [min_key(key[k], key[k ^ off]) for k in L]
                off *= 2
            assert len(set(key)) == 1
            best, kk = key[0]
            for k in L:
                if best < reg[k]["t"]:
                    _, _, u, v, n, m = own[kk % LANES]   # __shfl_sync
                    reg[k] = dict(t=best, u=u, v=v, n=n, wm=m)
        else:
            for k in L:
                if KINF < reg[k]["t"]:
                    rec = tris[node, 0]
                    _, u, v, _ = _mt(rec, o, d)
                    reg[k] = dict(t=KINF, u=u, v=v, n=tuple(rec[9:12]),
                                  wm=rec[12])
        node = node + 1 if box[0] and not leaf else int(h[6])
    r = reg[0]
    assert len({tuple(_bits([x["t"], *x["n"], x["u"], x["v"], x["wm"]]))
                for x in reg}) == 1
    t, n = r["t"], list(r["n"])
    hit = bool(t < t_hi)
    if (n[0] * d[0] + n[1] * d[1]) + n[2] * d[2] >= 0:
        n = [-x for x in n]
    return (t if hit else KINF, n, r["u"], r["v"], int(r["wm"]), hit, visits,
            from_table)


def min_key(a, b):
    """The kernel's merge of two lanes' (tk, k): the lexicographic least."""
    return b if b[0] < a[0] or (b[0] == a[0] and b[1] < a[1]) else a


def exact_reciprocal(h):
    """csrc/dda_kernel.cu's test: h = +-2^e with 1/h a normal float."""
    bits = int(np.array(h, np.float32).view(np.uint32))
    expo = (bits >> 23) & 0xFF
    return bits & 0x7FFFFF == 0 and 1 <= expo <= 253


def _to_int(x):
    """static_cast<int>(floorf(x)) on the card: NaN -> 0, saturating."""
    if x != x:
        return 0
    return int(min(max(np.floor(x), -2.0 ** 31), 2.0 ** 31 - 1))


def _probe(r, t):
    """What a round of csrc/dda_kernel.cu's march computes from its start
    t alone: the cell's index, whether the round marches, the next
    boundary and its axis, and the next t for a cell of jump 0."""
    te = t + r["eps"]
    cell, in_grid, lin = [], True, 0
    for a in range(3):
        p = r["o"][a] + te * r["d"][a]
        x = ((p - r["g"][a]) * r["inv_h"] if r["exact"]
             else (p - r["g"][a]) / r["h"])
        fl = np.floor(x)
        c = _to_int(fl)
        cc = min(max(c, 0), r["dims"][a] - 1)
        in_grid, lin = in_grid and cc == c, lin * r["dims"][a] + cc
        cell.append(fl)
    for a in range(3):
        # floor(x) + up for float(cell + up): equal inside the grid.
        ta = (((cell[a] + F(r["d"][a] > 0)) * r["h"] + r["g"][a])
              - r["o"][a]) * r["inv"][a]
        ta = KINF if abs(r["d"][a]) < F(1e-12) else ta
        if a == 0 or (ta != ta and t_new == t_new) or ta < t_new:
            t_new, new_axis = ta, a
    return dict(te=te, lin=lin, in_grid=in_grid,
                go=in_grid and t < r["tcap"], t_new=t_new, axis=new_axis,
                t_next=_max(_max(t_new, t + r["zero_h"]), te))


def march_thread(cells, origin, h, o, d, t_lo, t_hi, log=None):
    """csrc/dda_kernel.cu's thread: (t, n, mat, hit, rounds). ``log``,
    when given, gets how the march ended ("grid": it left the grid,
    "tcap": it reached tmin/tmax's cap, or "hit"), its longest run of
    jump-0 rounds in a row and its rounds with a jump > 0."""
    dims = cells.shape
    flat_cells = cells.reshape(-1)
    eps = F(1e-4) * h
    inv = [_inv(x) for x in d]
    exact = exact_reciprocal(h)
    for a in range(3):
        gmax = origin[a] + F(dims[a]) * h
        ta, tb = (origin[a] - o[a]) * inv[a], (gmax - o[a]) * inv[a]
        lo, hi = _min(ta, tb), _max(ta, tb)
        if a == 0:
            t_enter, t_exit, axis = lo, hi, 0
        else:
            if (lo != lo and t_enter == t_enter) or lo > t_enter:
                t_enter, axis = lo, a
            t_exit = _min(t_exit, hi)
    t_start = _max(t_enter, t_lo)
    inside = t_enter < t_lo
    alive = t_enter <= t_exit and t_start < t_hi and t_exit >= t_lo
    r = dict(o=o, d=d, inv=inv, g=origin, dims=dims, h=h, eps=eps,
             zero_h=F(0) * h, exact=exact,
             inv_h=F(1) / h if exact else None, tcap=_min(t_exit, t_hi))
    t, t_hit, axis_hit, mat, hit, rounds = t_start, KINF, 0, 0, False, 0
    end, run, longest, jumps = "grid", 0, 0, 0
    while alive:
        rounds += 1          # the rounds a lane enters marching
        q = _probe(r, t)
        if not q["go"]:
            end = "grid" if not q["in_grid"] else "tcap"
            break
        enc = int(flat_cells[q["lin"]])
        if enc > 0:
            hit, t_hit, axis_hit, mat, end = True, t, axis, enc, "hit"
            break
        jump = max(-2 - enc, 0)
        run = 0 if jump else run + 1
        longest, jumps = max(longest, run), jumps + (jump > 0)
        t = (q["t_next"] if jump == 0
             else _max(_max(q["t_new"], t + F(jump) * h), q["te"]))
        axis = q["axis"]
    if log is not None:
        log.append((end, longest, jumps))
    s = F(1) if d[axis_hit] < 0 else F(-1)
    face = inside and t_hit <= t_start + eps
    n = [-d[a] if face else F(a == axis_hit) * s for a in range(3)]
    return t_hit if hit else KINF, n, mat, hit, rounds


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _lanes(v, n):
    return (v.numpy() if torch.is_tensor(v)
            else np.full(n, v, np.float32)).astype(np.float32)


def walk_model(bvh, o, d, tmin, tmax):
    rows = bvh.rows.numpy()
    lo, hi = _lanes(tmin, len(o)), _lanes(tmax, len(o))
    with np.errstate(over="ignore", invalid="ignore"):   # IEEE, as on the card
        return [walk_thread(rows, o[i].numpy(), d[i].numpy(), lo[i], hi[i])
                for i in range(len(o))]


def group_model(bvh, o, d, tmin, tmax, n_shared=None):
    heads, tris = bvh.heads.numpy(), bvh.tris.numpy()
    staged = heads[:len(heads) if n_shared is None else n_shared].copy()
    lo, hi = _lanes(tmin, len(o)), _lanes(tmax, len(o))
    with np.errstate(over="ignore", invalid="ignore"):
        return [walk_group(heads, staged, tris, o[i].numpy(), d[i].numpy(),
                           lo[i], hi[i]) for i in range(len(o))]


def march_model(w, o, d, tmin, tmax, log=None):
    cells, origin = w.cells.numpy(), w.origin.numpy()
    h = F(w.voxel_size.item())
    lo, hi = _lanes(tmin, len(o)), _lanes(tmax, len(o))
    with np.errstate(over="ignore", invalid="ignore"):
        return [march_thread(cells, origin, h, o[i].numpy(), d[i].numpy(),
                             lo[i], hi[i], log) for i in range(len(o))]


def _same_bits(model, hit, fields):
    for i, m in enumerate(model):
        for f, got in zip(fields, m):
            want = getattr(hit, f)[i]
            if f in ("mat", "hit"):
                assert got == want.item(), (i, f)
            else:
                assert np.array_equal(_bits(got), _bits(want.numpy())), \
                    (i, f, got, want)


# ---- routing ---------------------------------------------------------------

def _walk_case():
    a, b, c, m = knot()
    bvh = mesh_bvh.build_mesh_bvh(a, b, c, m)
    return (bvh, *rays_at(a, 64, 0), 1e-3, INF)


def _dda_case():
    scene = cave()
    return (scene.voxels, *primary(scene, 8, 8), 1e-3, INF)


SWEEPS = {"walk": (mesh_bvh, "intersect_mesh", _walk_case, "bvh"),
          "dda": (dda, "intersect_voxels", _dda_case, "dda")}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweeps_take_the_plain_loop_on_the_cpu(name):
    mod, fn, case, key = SWEEPS[name]
    args = case()
    before = dict(kernels.LAUNCHES)
    mod.STATS.clear()
    got = getattr(mod, fn)(*args)
    assert mod.STATS["sweeps"] == 1 and mod.STATS["rounds"] > 0
    assert kernels.LAUNCHES == before
    want = getattr(mod, fn)(*args, impl="plain")
    for f in ("t", "n", "u", "v", "mat", "hit"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweeps_refuse_the_kernel_on_the_cpu(name):
    mod, fn, case, key = SWEEPS[name]
    before = kernels.LAUNCHES[key]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(mod, fn)(*case(), impl="kernel")
    assert kernels.LAUNCHES[key] == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launch wrappers take CUDA tensors only; nothing falls back."""
    bvh, o, d, _, _ = _walk_case()
    lo, hi = torch.full((64,), 1e-3), torch.full((64,), INF)
    with pytest.raises(ValueError, match="CUDA"):
        mesh_bvh.walk(bvh.heads, bvh.tris, o, d, lo, hi)
    w, o, d, _, _ = _dda_case()
    lo, hi = torch.full((64,), 1e-3), torch.full((64,), INF)
    with pytest.raises(ValueError, match="CUDA"):
        dda.march(w.cells, w.origin, w.voxel_size, o, d, lo, hi)


@pytest.mark.parametrize("impl", [None, "plain"])
def test_intersect_scene_passes_its_impl_to_both_sweeps(monkeypatch, impl):
    """The mesh and voxel sweeps get the scene sweep's resolved ``impl``,
    as the cluster sweep does."""
    seen = []

    def spy(real):
        def f(*args, **kw):
            seen.append((real.__name__, kw.get("impl")))
            return real(*args, **kw)
        return f

    monkeypatch.setattr(mesh_bvh, "intersect_mesh",
                        spy(mesh_bvh.intersect_mesh))
    monkeypatch.setattr(dda, "intersect_voxels", spy(dda.intersect_voxels))
    scene = dataclasses.replace(SCENE_BUILDERS["bunny"](),
                                voxels=cave().voxels)
    o, d = primary(scene, 8, 6)
    intersect.intersect_scene(scene, o, d, 1e-3, INF, impl=impl)
    assert seen == [("intersect_mesh", "plain"),
                    ("intersect_voxels", "plain")]
    with pytest.raises(ValueError, match="CUDA"):
        intersect.intersect_scene(scene, o, d, 1e-3, INF, impl="kernel")


def test_lanes_equal_col():
    """``_lanes`` (the kernels' per-ray bounds, filled on the device) gives
    ``_col``'s values, for numbers and tensors."""
    o = torch.zeros(5, 3)
    for v in (1e-3, INF, float("inf"), np.float32(0.1),
              torch.tensor(2.5), torch.arange(5.0)):
        got = intersect._lanes(v, o)
        assert got.is_contiguous() and got.dtype == torch.float32
        assert torch.equal(got, intersect._col(v, o)[:, 0])


# ---- packed rows and grid constants ----------------------------------------

@pytest.mark.parametrize("tree", ["sah", "lbvh"])
def test_rows_are_packed_once_per_tree(tree):
    a, b, c, m = knot()
    bvh = (mesh_bvh.build_mesh_bvh(a, b, c, m) if tree == "sah" else
           lbvh.build_lbvh(*(torch.from_numpy(x) for x in (a, b, c, m))))
    rows = bvh.rows
    assert rows is bvh.rows
    assert torch.equal(rows, mesh_bvh.node_rows(bvh))
    assert rows.shape == (bvh.n_nodes, 8 + 13 * mesh_bvh.LEAF_K)
    assert rows.is_contiguous() and rows.stride(0) * 4 % 16 == 0
    moved = bvh.to("cpu")
    assert moved is not bvh and moved.rows is not rows
    assert torch.equal(moved.rows, rows)


def test_a_rebuilt_tree_packs_its_own_rows():
    """The spinning mesh rebuilds its LBVH every frame: each frame's tree
    carries the rows of its own nodes."""
    spin = SCENE_BUILDERS["spinning_mesh"]()
    a, b = spin.at_time(0.0).mesh, spin.at_time(1.3).mesh
    assert not torch.equal(a.rows, b.rows)
    for bvh in (a, b):
        assert torch.equal(bvh.rows, mesh_bvh.node_rows(bvh))


@pytest.mark.parametrize("tree", ["sah", "lbvh"])
def test_heads_and_tris_hold_the_rows_values(tree):
    """The walk kernel's split layout: a 32-byte header a node (the rows'
    first 8 floats) and a 64-byte record a triangle (its 13 floats of the
    row, 3 zeros), each 16-byte aligned, packed once a tree."""
    a, b, c, m = knot()
    bvh = (mesh_bvh.build_mesh_bvh(a, b, c, m) if tree == "sah" else
           lbvh.build_lbvh(*(torch.from_numpy(x) for x in (a, b, c, m))))
    N, K = bvh.n_nodes, mesh_bvh.LEAF_K
    heads, tris = bvh.heads, bvh.tris
    assert heads is bvh.heads and tris is bvh.tris
    assert heads.shape == (N, 8) and tris.shape == (N, K, 16)
    for x in (heads, tris):
        assert x.dtype == torch.float32 and x.is_contiguous()
        assert x.data_ptr() % 16 == 0
    assert heads.stride(0) * 4 == 32 and tris.stride(1) * 4 == 64
    assert torch.equal(heads, bvh.rows[:, :8])
    assert torch.equal(tris[..., :13], bvh.rows[:, 8:].view(N, K, 13))
    assert not tris[..., 13:].any()
    moved = bvh.to("cpu")
    assert moved.heads is not heads and moved.tris is not tris
    assert torch.equal(moved.heads, heads) and torch.equal(moved.tris, tris)


def test_a_rebuilt_tree_packs_its_own_heads_and_tris():
    spin = SCENE_BUILDERS["spinning_mesh"]()
    a, b = spin.at_time(0.0).mesh, spin.at_time(1.3).mesh
    assert not torch.equal(a.tris, b.tris)
    for bvh in (a, b):
        assert torch.equal(bvh.heads, bvh.rows[:, :8])
        assert torch.equal(bvh.tris[..., :13],
                           bvh.rows[:, 8:].view(-1, mesh_bvh.LEAF_K, 13))


def test_walk_kernel_layout_constants_match_the_source():
    """The wrapper's layout and the kernel's: header and record sizes,
    triangles a leaf; four lanes a ray."""
    src = (CSRC / "bvh_kernel.cu").read_text()
    for expr in (f"constexpr int kLeafK = {mesh_bvh.LEAF_K};",
                 f"constexpr int kHead4 = {mesh_bvh.HEAD_F // 4};",
                 f"constexpr int kTri4 = {mesh_bvh.TRI_F // 4};",
                 f"constexpr int kLanes = {LANES};",
                 "constexpr int kThreads = kBlockRays * kLanes;",
                 "constexpr int kWarpRays = 32 / kLanes;"):
        assert expr in src, expr


# An H100 as yacge_bvh_limits reports it: 232,448 bytes of shared memory a
# block may opt in to, 132 SMs, one block of 1,024 threads an SM (the
# registers allow no second), four lanes a ray.
H100 = {"sms": 132, "threads": 1024, "lanes": LANES}


def _h100_limits(lib, device, smem):
    per_sm = min(1, 228 * 1024 // (smem + 1024))
    return 232448, H100["sms"], per_sm, H100["threads"], H100["lanes"]


@pytest.mark.parametrize("nodes,n_shared", [
    (1023, 1023), (2047, 2047), (4095, 4095), (8191, 4096)])
def test_walk_launch_shape(monkeypatch, nodes, n_shared):
    """Headers staged whole up to ``HEAD_BUDGET`` (every tree the port's
    scenes build: bunny 1,023, knot and museum 2,047, all_meshes 4,095
    nodes), else the first 4,096 in pre-order; as many blocks as the card
    holds (28,800 rays are 3,600 batches of a warp's 8 rays), fewer for a
    small sweep: at least 4 batches a block."""
    monkeypatch.setattr(mesh_bvh, "_limits", _h100_limits)
    shape = mesh_bvh.walk_shape(nodes, 28800, torch.device("cuda", 0),
                                lib="h100")
    assert shape == dict(H100, budget=131072, n_shared=n_shared,
                         shared_bytes=n_shared * 32, blocks=132,
                         blocks_per_sm=1)
    assert mesh_bvh.shared_nodes(nodes, mesh_bvh.HEAD_BUDGET) == n_shared
    assert (n_shared * 32 > 48 * 1024) == (nodes > 1535)
    for P, want in ((1, 1), (7, 1), (32, 1), (33, 2), (4097, 129),
                    (8448, 132)):
        got = mesh_bvh.walk_shape(nodes, P, "cuda:0", lib="h100")["blocks"]
        assert got == want == mesh_bvh.grid_blocks(P, 132, 1, 8)
    # A card whose blocks may opt in to less stages less.
    monkeypatch.setattr(mesh_bvh, "_limits",
                        lambda *a: (49152, *_h100_limits(*a)[1:]))
    small = mesh_bvh.walk_shape(nodes, 28800, "cuda:0", lib="small")
    assert small["budget"] == 49152
    assert small["n_shared"] == min(nodes, 1536)


def test_dda_kernel_grid_constants_equal_the_plain_loops():
    """What csrc/dda_kernel.cu derives from its arguments (the cells'
    shape, the origin and voxel-size tensors) is what ``_step`` reads."""
    w = cave().voxels
    g = dda.grid_constants(w, "cpu")
    nx, ny, nz = w.cells.shape
    assert [nx, ny, nz] == (g["top"] + 1).tolist()
    # lin = (x * ny + y) * nz + z in the kernel
    assert [ny * nz, nz, 1] == g["strides"].tolist()
    assert torch.equal(g["gmin"], w.origin)
    assert torch.equal(g["h_t"], w.voxel_size)
    h = F(w.voxel_size.item())
    assert g["h"] == float(h)
    assert g["eps"] == float(F(1e-4) * h)
    src = (CSRC / "dda_kernel.cu").read_text()
    # lin = (x * ny + y) * nz + z in 32 bits: march refuses larger grids.
    for expr in ("r.eps = 1e-4f * r.h;", "r.zero_h = 0.0f * r.h;",
                 "int dims[3], yz;",
                 "r.yz = gy * gz;",
                 "const int lin = cc[0] * r.yz + (cc[1] * r.dims[2] + cc[2]);",
                 "r.dims[0] = gx;", "r.dims[1] = gy;", "r.dims[2] = gz;"):
        assert expr in src, expr
    assert "long long" not in src
    assert torch.equal(g["cells"], w.cells.reshape(-1).to(torch.int32))
    assert w.cells.dtype == torch.int16


# ---- the kernels' models ---------------------------------------------------

WALK_FIELDS = ("t", "n", "u", "v", "mat", "hit")
DDA_FIELDS = ("t", "n", "mat", "hit")


def _walk_inputs():
    """Bunny primary rays; knot rays with per-ray bounds; parked lanes; a
    tmax of inf (the plain walk's first round then takes INF)."""
    bunny = SCENE_BUILDERS["bunny"]()
    o, d = primary(bunny, 12, 8)
    a, b, c, m = knot()
    tree = mesh_bvh.build_mesh_bvh(a, b, c, m)
    ko, kd = rays_at(a, 96, 1)
    rs = np.random.RandomState(2)
    lo = torch.from_numpy(rs.uniform(0.0, 0.5, 96).astype(np.float32))
    hi = torch.from_numpy(rs.uniform(1.0, 8.0, 96).astype(np.float32))
    # Every knot triangle twice, the twins with materials 2i and 2i + 1:
    # equal t in a leaf, where the first twin must win.
    twins = mesh_bvh.build_mesh_bvh(
        *(np.repeat(x, 2, axis=0) for x in (a, b, c)),
        np.arange(2 * len(a), dtype=np.int32))
    return {"bunny": (bunny.mesh, o, d, 1e-3, INF),
            "knot_bounds": (tree, ko, kd, lo, hi),
            "twins": (twins, ko[:48], kd[:48], 1e-3, INF),
            # A tree of one leaf (3 triangles) under a tmax of inf: the
            # root is a leaf, so a ray that misses takes INF there with
            # triangle 0's data.
            "one_leaf_inf": (mesh_bvh.build_mesh_bvh(a[:3], b[:3], c[:3],
                                                     m[:3]),
                             *rays_at((a[:3] + b[:3] + c[:3]) / 3, 16, 1,
                                      spread=1.0), 1e-3, float("inf")),
            "parked": (tree, torch.full((4, 3), 2.9e30), kd[:4], 1e-3, INF),
            "inf_tmax": (tree, ko[:16], kd[:16], 1e-3, float("inf"))}


@pytest.mark.parametrize("case", ["bunny", "knot_bounds", "parked",
                                  "inf_tmax", "twins", "one_leaf_inf"])
def test_walk_thread_model_equals_the_plain_walk(case):
    """One ray's whole walk in a thread, run to its own end, gives the
    lockstep walk's outputs bit for bit; its visits are what ``walk_work``
    counts."""
    args = _walk_inputs()[case]
    model = walk_model(*args)
    _same_bits(model, mesh_bvh.intersect_mesh(*args), WALK_FIELDS)
    work = mesh_bvh.walk_work(*args)
    visits = [m[-1] for m in model]
    assert work["visits"] == sum(visits)
    assert work["max_visits"] == max(visits) == work["rounds"]
    if case == "parked":
        assert visits == [1] * 4 and work["tri_tests"] == 0


def test_walk_thread_model_matches_jax():
    """The model against JAX ``intersect_mesh`` on an LBVH, with
    tests/test_torch_mesh_bvh.py's contract."""
    a, b, c, m = knot()
    jt = jlbvh.build_lbvh(a, b, c, m)
    pt = lbvh.build_lbvh(*(torch.from_numpy(x) for x in (a, b, c, m)))
    o, d = rays_at(a, 160, 3)
    tmax = np.random.RandomState(4).uniform(2.0, 12.0, 160).astype(np.float32)
    want = jbvh.intersect_mesh(jt, jnp.asarray(o.numpy()),
                               jnp.asarray(d.numpy()), np.float32(1e-3),
                               jnp.asarray(tmax))
    model = walk_model(pt, o, d, 1e-3, torch.from_numpy(tmax))
    hit = np.asarray(want.hit)
    assert hit.sum() > 50
    np.testing.assert_array_equal([x[5] for x in model], hit)
    tg = np.float32([x[0] for x in model])[hit]
    tw = np.asarray(want.t)[hit]
    np.testing.assert_allclose(tg, tw, rtol=1e-5, atol=1e-6)
    same = np.abs(tg - tw) <= 1e-6 * np.abs(tw)
    assert same.mean() > 0.99
    np.testing.assert_array_equal(np.int32([x[4] for x in model])[hit][same],
                                  np.asarray(want.mat)[hit][same])


@pytest.mark.parametrize("case,n_shared", [
    ("bunny", None), ("knot_bounds", None), ("parked", None),
    ("inf_tmax", None), ("twins", None), ("one_leaf_inf", None),
    ("knot_bounds", 9), ("bunny", 200)])
def test_lane_group_model_equals_the_plain_walk(case, n_shared):
    """Four lanes a ray, the (tk, k) shuffle reduction and the headers split
    between the staged copy and the table give the plain walk's outputs
    bit for bit: on the bunny's LBVH, on the SAH tree (leaves of fewer than
    four triangles) with per-ray bounds, on parked rays, with a tmax of inf,
    on twinned triangles (equal t in a leaf: the first twin's material), on
    a one-leaf tree under a tmax of inf, and with fewer headers staged
    than the tree has."""
    args = _walk_inputs()[case]
    bvh = args[0]
    model = group_model(*args, n_shared=n_shared)
    _same_bits(model, mesh_bvh.intersect_mesh(*args), WALK_FIELDS)
    assert [m[6] for m in model] == [m[6] for m in walk_model(*args)]
    table_reads = sum(m[7] for m in model)
    assert (table_reads > 0) == (n_shared is not None)
    if case == "knot_bounds":
        count = bvh.tri_count
        assert ((count > 0) & (count < mesh_bvh.LEAF_K)).any()
    if case == "twins":
        mat = np.int32([m[4] for m in model])[[m[5] for m in model]]
        assert len(mat) > 20 and (mat % 2 == 0).all()
    if case == "one_leaf_inf":
        # Rays that miss take INF at the leaf (hit, as INF < inf).
        t = np.float32([m[0] for m in model])
        assert bvh.n_nodes == 1 and 0 < (t == KINF).sum() < len(t)


def _dda_inputs():
    scene = cave()
    o, d = primary(scene, 12, 8, 2)
    w = scene.voxels
    rs = np.random.RandomState(5)
    lo = torch.from_numpy(rs.uniform(0.0, 1.0, len(o)).astype(np.float32))
    hi = torch.from_numpy(rs.uniform(2.0, 40.0, len(o)).astype(np.float32))
    axis = d.clone()
    axis[:8] = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0],
                             [-1.0, 0, 0]] * 2)
    return {"cave": (w, o, d, 1e-3, INF),
            "cave_bounds": (w, o, d, lo, hi),
            "axis_aligned": (w, o, axis, 1e-3, INF),
            "parked": (w, torch.full((4, 3), 2.9e30), d[:4], 1e-3, INF)}


@pytest.mark.parametrize("case", ["cave", "cave_bounds", "axis_aligned",
                                  "parked"])
def test_march_thread_model_equals_the_plain_loop(case):
    args = _dda_inputs()[case]
    model = march_model(*args)
    _same_bits(model, dda.intersect_voxels(*args), DDA_FIELDS)
    work = dda.march_work(*args)
    rounds = [m[-1] for m in model]
    assert work["rounds"] == sum(rounds)
    assert work["max_rounds"] == max(rounds)


def test_march_thread_model_matches_jax():
    """The model against JAX ``intersect_voxels`` on the cave, with
    tests/test_torch_dda.py's contract."""
    scene = cave()
    w = scene.voxels
    jw = jdda.VoxelWorld(cells=jnp.asarray(w.cells.numpy()),
                         origin=jnp.asarray(w.origin.numpy()),
                         voxel_size=jnp.asarray(w.voxel_size.numpy()))
    o, d = primary(scene, 12, 8, 1)
    want = jdda.intersect_voxels(jw, jnp.asarray(o.numpy()),
                                 jnp.asarray(d.numpy()), np.float32(1e-3),
                                 np.float32(1e9))
    model = march_model(w, o, d, 1e-3, 1e9)
    hit = np.asarray(want.hit)
    assert hit.sum() > 50
    np.testing.assert_array_equal([x[3] for x in model], hit)
    np.testing.assert_array_equal([x[2] for x in model],
                                  np.asarray(want.mat))
    np.testing.assert_array_equal(np.float32([x[1] for x in model])[hit],
                                  np.asarray(want.n)[hit])
    np.testing.assert_allclose(np.float32([x[0] for x in model]),
                               np.asarray(want.t), rtol=1e-5, atol=1e-5)


def test_warp_efficiency_counts_a_warp_as_its_longest_ray():
    lane = torch.tensor([1] * 32 + [0] * 31 + [64])
    assert kernels.warp_efficiency(lane) == (32 + 64) / (32 * 1 + 32 * 64)
    assert kernels.warp_efficiency(torch.tensor([3] * 40)) == 120 / 192
    assert kernels.warp_efficiency(torch.zeros(0, dtype=torch.int64)) == 1.0


# ---- the DDA kernel's thread on the stress grid ----------------------------

STRESS_RAYS = 256


def _stress(h):
    return dda_stress_cases("cpu", STRESS_RAYS)[f"stress_h{h}"]


@pytest.mark.parametrize("h", STRESS_H)
def test_march_thread_model_equals_the_plain_loop_on_the_stress_grid(h):
    """The thread gives the plain loop's outputs bit for bit on the stress
    grid (grazing rays through distance-1 cells, jumps, exits, per-ray
    tmax, rays parallel to axes, from outside the grid and from inside a
    solid cell), at a voxel size with an exact reciprocal (1, 0.5, 2) and
    without (0.3), and enters as many rounds a ray as the plain loop."""
    args = _stress(h)
    model = march_model(*args)
    _same_bits(model, dda.intersect_voxels(*args, compact=False),
               DDA_FIELDS)
    work, _ = dda.march_counts(*args)
    assert [m[4] for m in model] == work["rounds"].tolist()


@pytest.mark.parametrize("h", STRESS_H)
def test_stress_grid_ends_marches_every_way(h):
    """The stress grid's rays end their marches in every way the kernel's
    loop has (a hit, leaving the grid, reaching a per-ray tmax), graze for
    20 rounds or more of jump 0 in a row, and jump; rays parallel to two
    axes and to one, and rays that start inside a solid cell (the hit at
    the start, normal -d), are among them."""
    w, o, d, lo, hi = _stress(h)
    log = []
    model = march_model(w, o, d, lo, hi, log=log)
    assert {end for end, _, _ in log} == {"hit", "grid", "tcap"}
    assert max(run for _, run, _ in log) >= 20
    assert sum(jumps > 0 for _, _, jumps in log) >= STRESS_RAYS // 8
    assert ((d == 0).sum(1) == 2).any() and ((d == 0).sum(1) == 1).any()
    hit_at_start = [i for i, m in enumerate(model)
                    if m[3] and np.array_equal(m[1], -d[i].numpy())]
    assert len(hit_at_start) >= 8


def test_one_select_minimum_and_maximum_keep_torch_order():
    """csrc/dda_kernel.cu's min_nan, max_nan and first-of-equal-minima
    test, one select each, pick the operand the three-way forms (torch's
    minimum and maximum, the plain loop's torch.min over the axes) pick:
    bit for bit on +-0, +-inf, NaNs of two payloads, subnormals and random
    pairs (equal ones and sign flips among them)."""
    def min_sel(a, b):
        return b if a == a and not b >= a else a

    def max_sel(a, b):
        return b if a == a and not b <= a else a

    def first_three(ta, t_new):
        return (ta != ta and t_new == t_new) or ta < t_new

    def first_sel(ta, t_new):
        return t_new == t_new and not ta >= t_new

    special = np.array([0x0, 0x80000000, 0x3F800000, 0xBF800000, 0x7F800000,
                        0xFF800000, 0x7FC00001, 0xFFC00002, 0x1, 0x80000001,
                        0x7F7FFFFF], np.uint32).view(F)
    rs = np.random.RandomState(9)
    x = rs.randint(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32)
    y = rs.randint(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32)
    y[::3] = x[::3]
    y[1::5] = x[1::5] ^ np.uint32(0x80000000)
    pairs = [(a, b) for a in special for b in special]
    pairs += list(zip(x.view(F), y.view(F)))
    for a, b in pairs:
        assert _bits(min_sel(a, b)) == _bits(_min(a, b)), (a, b)
        assert _bits(max_sel(a, b)) == _bits(_max(a, b)), (a, b)
        assert first_sel(a, b) == first_three(a, b), (a, b)


def test_exact_reciprocal_takes_powers_of_two_only():
    """The kernel multiplies by 1/h instead of dividing by h only where
    that is exact: h = +-2^e with 1/h a normal float. There x / h equals
    x * (1/h) bit for bit, subnormal and overflowing quotients included."""
    yes = [1.0, 0.5, 2.0, 0.25, 1024.0, -4.0, 2.0 ** -126, 2.0 ** 126]
    no = [0.3, 3.0, 0.0, -0.0, 2.0 ** 127, 2.0 ** -127, 1.5, float("inf"),
          float("nan")]
    assert all(exact_reciprocal(F(h)) for h in yes)
    assert not any(exact_reciprocal(F(h)) for h in no)
    rs = np.random.RandomState(7)
    x = rs.randint(-2 ** 31, 2 ** 31, 20000).astype(np.int32).view(F)
    x = x[np.isfinite(x)]
    with np.errstate(over="ignore", under="ignore"):
        for h in map(F, yes):
            assert np.array_equal(_bits(x / h), _bits(x * (F(1) / h))), h


# ---- the DDA wrapper's host side -------------------------------------------

def test_march_refuses_grids_its_cell_index_cannot_hold():
    """The kernel's linear cell index is 32-bit: ``march`` refuses a grid
    of 2^31 cells or more (and an empty one) before it looks at devices,
    and lets a grid of 2^31 - 1 cells through to the device check. Meta
    tensors: nothing is allocated."""
    w, o, d, _, _ = _dda_case()
    lo, hi = (torch.full((o.shape[0],), v) for v in (1e-3, INF))
    meta = lambda *shape: torch.empty(shape, dtype=torch.int16,
                                      device="meta")
    for cells in (meta(2048, 1024, 1024), meta(1 << 16, 1 << 16, 1),
                  meta(0, 8, 8)):
        with pytest.raises(ValueError, match="2\\^31"):
            dda.march(cells, w.origin, w.voxel_size, o, d, lo, hi)
    assert dda.MAX_CELLS == 2 ** 31 - 1
    with pytest.raises(ValueError, match="CUDA"):
        dda.march(meta(1, 1, dda.MAX_CELLS), w.origin, w.voxel_size, o, d,
                  lo, hi)
