"""The port's mesh BVH against the JAX package's: the host SAH build table
for table, the skip-link walk against JAX ``intersect_mesh`` and a
brute-force nearest hit, the contracts of tests/test_mesh_bvh.py, and the
compacted walk bit-equal to the uncompacted one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yetanotherconsolegameengine_tpu.ops import lbvh as jlbvh
from yetanotherconsolegameengine_tpu.ops import mesh_bvh as jbvh
from yetanotherconsolegameengine_tpu.scene import mesh_loader as jml
from yetanotherconsolegameengine_tpu_torch.ops import lbvh, mesh_bvh
from yetanotherconsolegameengine_tpu_torch.ops.intersect import INF

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

FIELDS = ("bmin", "bmax", "skip", "tri_start", "tri_count", "a", "e1", "e2",
          "n", "mat")


def random_mesh(seed, n=200):
    rs = np.random.RandomState(seed)
    a = rs.randn(n, 3).astype(np.float32)
    b = a + 0.3 * rs.randn(n, 3).astype(np.float32)
    c = a + 0.3 * rs.randn(n, 3).astype(np.float32)
    return a, b, c, rs.randint(0, 7, n).astype(np.int32)


def random_rays(seed, n=256, spread=4.0, aim=None):
    """Rays from Gaussian origins; random directions, or directions toward
    jittered points of ``aim`` (K, 3) when given."""
    rs = np.random.RandomState(seed)
    o = (spread * rs.randn(n, 3)).astype(np.float32)
    if aim is None:
        d = rs.randn(n, 3)
    else:
        d = aim[rs.randint(0, len(aim), n)] + 0.2 * rs.randn(n, 3) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def knot_mesh():
    tris = jml.make_knot(seg_u=48, seg_v=6)
    mats = (np.arange(len(tris)) % 3).astype(np.int32)
    return tris[:, 0], tris[:, 1], tris[:, 2], mats


def torch_hit(bvh, o, d, tmin=1e-3, tmax=1e9, **kw):
    return mesh_bvh.intersect_mesh(bvh, torch.from_numpy(o),
                                   torch.from_numpy(d), tmin, tmax, **kw)


def brute_force(a, b, c, o, d, tmin, tmax):
    """Nearest double-sided Möller–Trumbore hit over every triangle, in
    float64: (t, winner index), t = inf on a miss."""
    a, b, c, o, d = (x.astype(np.float64) for x in (a, b, c, o, d))
    e1, e2 = b - a, c - a
    h = np.cross(d[:, None], e2[None])
    det = np.einsum("nk,pnk->pn", e1, h)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / det
        s = o[:, None] - a[None]
        u = np.einsum("pnk,pnk->pn", s, h) * inv
        q = np.cross(s, e1[None])
        v = np.einsum("pk,pnk->pn", d, q) * inv
        t = np.einsum("nk,pnk->pn", e2, q) * inv
    ok = ((np.abs(det) >= 1e-8) & (u >= 0) & (u <= 1) & (v >= 0)
          & (u + v <= 1) & (t >= tmin) & (t <= tmax))
    t = np.where(ok, t, np.inf)
    return t.min(1), t.argmin(1)


@pytest.mark.parametrize("mesh", ["random", "knot"])
def test_build_mesh_bvh_equals_jax(mesh):
    a, b, c, m = random_mesh(0) if mesh == "random" else knot_mesh()
    want = jbvh.build_mesh_bvh(a, b, c, m)
    got = mesh_bvh.build_mesh_bvh(a, b, c, m)
    for f in FIELDS:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_build_invariants():
    a, b, c, m = random_mesh(1)
    bvh = mesh_bvh.build_mesh_bvh(a, b, c, m)
    skip, count = bvh.skip.numpy(), bvh.tri_count.numpy()
    start, N = bvh.tri_start.numpy(), bvh.n_nodes
    assert np.all(skip > np.arange(N)) and np.all(skip <= N)
    covered = np.zeros(len(a), bool)
    for i in np.nonzero(count)[0]:
        assert count[i] <= mesh_bvh.LEAF_K
        seg = slice(start[i], start[i] + count[i])
        assert not covered[seg].any()
        covered[seg] = True
    assert covered.all()
    bmin, bmax = bvh.bmin.numpy(), bvh.bmax.numpy()
    assert np.all(bmin >= bmin[0]) and np.all(bmax <= bmax[0])
    rows = mesh_bvh.node_rows(bvh)
    assert rows.shape == (N, 8 + 13 * mesh_bvh.LEAF_K)


@pytest.mark.parametrize("tree", ["sah", "lbvh"])
@pytest.mark.parametrize("mesh", ["random", "knot"])
def test_intersect_mesh_matches_jax(tree, mesh):
    """Hit masks equal, t within 1e-5 relative, and where t agrees equal
    materials and normals within 1e-5."""
    a, b, c, m = random_mesh(2, 300) if mesh == "random" else knot_mesh()
    if tree == "sah":
        jt, pt = (jbvh.build_mesh_bvh(a, b, c, m),
                  mesh_bvh.build_mesh_bvh(a, b, c, m))
    else:
        jt = jlbvh.build_lbvh(a, b, c, m)
        pt = lbvh.build_lbvh(*(torch.from_numpy(x) for x in (a, b, c, m)))
    o, d = random_rays(3, 2048, spread=3.0, aim=a)
    tmax = np.random.RandomState(4).uniform(2.0, 12.0, len(o)) \
        .astype(np.float32)
    want = jbvh.intersect_mesh(jt, jnp.asarray(o), jnp.asarray(d),
                               np.float32(1e-3), jnp.asarray(tmax))
    got = torch_hit(pt, o, d, 1e-3, torch.from_numpy(tmax))
    hit = np.asarray(want.hit)
    assert hit.sum() > 100
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    tw, tg = np.asarray(want.t)[hit], got.t.numpy()[hit]
    np.testing.assert_allclose(tg, tw, rtol=1e-5, atol=1e-6)
    same = np.abs(tg - tw) <= 1e-6 * np.abs(tw)
    assert same.mean() > 0.99
    np.testing.assert_array_equal(got.mat.numpy()[hit][same],
                                  np.asarray(want.mat)[hit][same])
    np.testing.assert_allclose(got.n.numpy()[hit][same],
                               np.asarray(want.n)[hit][same], atol=1e-5)
    assert np.all(got.t.numpy()[~hit] == INF)


def test_traversal_equals_brute_force():
    """The nearest hit of every triangle, and its material; tmin respected."""
    a, b, c, m = random_mesh(5, 300)
    bvh = mesh_bvh.build_mesh_bvh(a, b, c, m)
    o, d = random_rays(6, 512)
    for tmin in (1e-3, 2.0):
        h = torch_hit(bvh, o, d, tmin)
        t_ref, win = brute_force(a, b, c, o, d, tmin, 1e9)
        hit_ref = np.isfinite(t_ref)
        np.testing.assert_array_equal(h.hit.numpy(), hit_ref)
        np.testing.assert_allclose(h.t.numpy()[hit_ref], t_ref[hit_ref],
                                   rtol=1e-4, atol=1e-5)
        assert np.all(h.t.numpy()[hit_ref] >= tmin)
        np.testing.assert_array_equal(h.mat.numpy()[hit_ref],
                                      m[win[hit_ref]])


def test_traversal_respects_tmax():
    a, b, c, m = random_mesh(7, 100)
    bvh = mesh_bvh.build_mesh_bvh(a, b, c, m)
    o, d = random_rays(8, 128, aim=a)
    far = torch_hit(bvh, o, d)
    hit = far.hit.numpy()
    assert hit.any()
    near = np.where(hit, far.t.numpy() * 0.99, 1.0).astype(np.float32)
    assert not (torch_hit(bvh, o, d, 1e-3, torch.from_numpy(near)).hit.numpy()
                & hit).any()


def test_normals_face_the_ray():
    tris = jml.make_icosphere(2)
    bvh = mesh_bvh.build_mesh_bvh(tris[:, 0], tris[:, 1], tris[:, 2],
                                  np.zeros(len(tris), np.int32))
    o, d = random_rays(9, 256, spread=3.0, aim=tris[:, 0])
    h = torch_hit(bvh, o, d)
    hit = h.hit.numpy()
    assert hit.sum() > 10
    assert np.all(np.sum(h.n.numpy() * d, axis=1)[hit] < 0.0)


@pytest.mark.parametrize("check_every", [1, 3, 8])
def test_compacted_walk_bit_equal_to_uncompacted(monkeypatch, check_every):
    """Narrowing the batch (at any check cadence) gives the uncompacted
    walk's results bit for bit."""
    monkeypatch.setattr(mesh_bvh, "COMPACT_MIN", 64)
    monkeypatch.setattr(mesh_bvh, "CHECK_EVERY", check_every)
    a, b, c, m = knot_mesh()
    bvh = lbvh.build_lbvh(*(torch.from_numpy(x) for x in (a, b, c, m)))
    o, d = random_rays(10, 4096, spread=2.5)
    mesh_bvh.STATS.clear()
    got = torch_hit(bvh, o, d)
    assert mesh_bvh.STATS["compactions"] >= 2
    want = torch_hit(bvh, o, d, compact=False)
    for f in ("t", "n", "u", "v", "mat", "hit"):
        g, w = getattr(got, f).numpy(), getattr(want, f).numpy()
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=f)


def test_dead_lanes_leave_after_the_root():
    """Lanes parked at 2.9e30 (finished wavefront lanes) end after one
    round with no hit and finite results, even along an axis (d = 0)."""
    a, b, c, m = knot_mesh()
    bvh = mesh_bvh.build_mesh_bvh(a, b, c, m)
    o = np.full((6, 3), 2.9e30, np.float32)
    d = np.float32([[0, 0, -1], [1, 0, 0], [0, -1, 0], [0.6, 0.0, -0.8],
                    [-0.48, 0.6, -0.64], [0, 0, 1]])
    state = dict(node=torch.zeros(6, dtype=torch.int64),
                 t=torch.full((6,), 1e9), wn=torch.zeros((6, 3)),
                 wm=torch.zeros(6), u=torch.zeros(6), v=torch.zeros(6),
                 o=torch.from_numpy(o), d=torch.from_numpy(d),
                 inv=mesh_bvh._safe_div(torch.ones(6, 3), torch.from_numpy(d)),
                 tlo=torch.full((6,), 1e-3))
    mesh_bvh._walk(mesh_bvh.node_rows(bvh), state, bvh.n_nodes)
    assert (state["node"] == bvh.n_nodes).all()
    h = torch_hit(bvh, o, d)
    assert not h.hit.any()
    for f in ("t", "n", "u", "v"):
        assert torch.isfinite(getattr(h, f)).all(), f
