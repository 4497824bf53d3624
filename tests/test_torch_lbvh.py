"""The port's LBVH against the JAX package's: the DFS layout and Morton
codes exactly, ``build_lbvh`` against ``jax.jit(build_lbvh)`` (order,
boxes and skip links exact, triangle arrays within 1e-6), the contracts of
tests/test_lbvh.py, and the small-mesh scenes' tables and first hits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yetanotherconsolegameengine_tpu.ops import intersect as jintersect
from yetanotherconsolegameengine_tpu.ops import lbvh as jlbvh
from yetanotherconsolegameengine_tpu.scene import builders as jbuilders
from yetanotherconsolegameengine_tpu.scene import mesh_loader as jml
from yetanotherconsolegameengine_tpu_torch.ops import intersect, lbvh, mesh_bvh
from yetanotherconsolegameengine_tpu_torch.scene import builders, tables
from tests.test_torch_mesh_bvh import (FIELDS, random_mesh, random_rays,
                                       torch_hit)
from tests.test_torch_scene import flatten_jax_scene

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

MESH_SCENES = ["bunny", "teapot", "cow", "glass_gem", "all_meshes", "museum"]
_TRI_FIELDS = ("e1", "e2", "n")


def torch_lbvh(a, b, c, m):
    return lbvh.build_lbvh(*(torch.from_numpy(np.ascontiguousarray(x))
                             for x in (a, b, c, m)))


def assert_lbvh_equal(got, want):
    """Order, boxes, skip links and leaf ranges exact; triangles: vertices
    and materials exact, edges and normals within 1e-6."""
    for f in FIELDS:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f
        if f in _TRI_FIELDS:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("leaves", [1, 2, 8, 64, 512])
def test_dfs_layout_equals_jax(leaves):
    got, want = lbvh._dfs_layout(leaves), jlbvh._dfs_layout(leaves)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    heap, skip, leaf_ord = got
    N = 2 * leaves - 1
    assert sorted(heap) == list(range(1, N + 1))
    assert np.all(skip > np.arange(N)) and np.all(skip <= N)
    assert sorted(leaf_ord[leaf_ord >= 0]) == list(range(leaves))


def test_morton3_equals_jax():
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.uniform(-0.1, 1.1, (3, 4096)),
                        np.float32([[0.0, 1.0, 0.5, 1023.5 / 1023]] * 3)],
                       1).astype(np.float32)
    want = np.asarray(jlbvh.morton3(*(jnp.asarray(v) for v in x)))
    got = lbvh.morton3(*(torch.from_numpy(v) for v in x))
    assert got.max() < 1 << 30
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("mesh", ["random", "icosphere", "knot", "n3",
                                  "n17", "n65"])
def test_build_lbvh_equals_jitted_jax(mesh):
    if mesh == "icosphere":
        tris = jml.transform_mesh(jml.make_icosphere(3), scale=2.0,
                                  translate=(0.0, 0.0, -3.5))
    elif mesh == "knot":
        tris = jml.make_knot(seg_u=48, seg_v=6)
    if mesh in ("icosphere", "knot"):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        m = (np.arange(len(a)) % 5).astype(np.int32)
    else:
        a, b, c, m = random_mesh(11, 230 if mesh == "random"
                                 else int(mesh[1:]))
    want = jax.jit(jlbvh.build_lbvh)(a, b, c, jnp.asarray(m))
    assert_lbvh_equal(torch_lbvh(a, b, c, m), want)


def test_lbvh_matches_sah_traversal():
    a, b, c, m = random_mesh(12, 230)
    o, d = random_rays(13, 512, aim=a)
    h1 = torch_hit(mesh_bvh.build_mesh_bvh(a, b, c, m), o, d)
    h2 = torch_hit(torch_lbvh(a, b, c, m), o, d)
    hit = h1.hit.numpy()
    assert hit.sum() > 50
    np.testing.assert_array_equal(h2.hit.numpy(), hit)
    np.testing.assert_allclose(h2.t.numpy()[hit], h1.t.numpy()[hit],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(h2.mat.numpy()[hit], h1.mat.numpy()[hit])


@pytest.mark.parametrize("n", [3, 17, 65])
def test_lbvh_nonpow2_padding(n):
    """Zero triangles pad to a power-of-two leaf count; hits stay finite."""
    a, b, c, m = random_mesh(14 + n, n)
    bvh = torch_lbvh(a, b, c, m)
    assert bvh.n_tris == (bvh.n_nodes + 1) // 2 * lbvh.LEAF_K + \
        mesh_bvh.LEAF_K
    assert torch.isfinite(bvh.n).all() and torch.isfinite(bvh.e1).all()
    o, d = random_rays(15, 64, aim=a)
    h = torch_hit(bvh, o, d)
    assert h.hit.any()
    assert torch.isfinite(h.t[h.hit]).all() and torch.isfinite(h.n).all()


def test_lbvh_straddling_leaf_normals_finite():
    """A winner in a leaf of one valid and three padded triangles has a
    finite unit normal."""
    n = 5
    a = np.array([[i * 10.0, 0.0, 0.0] for i in range(n)], np.float32)
    b = a + np.float32([1.0, 0.0, 0.0])
    c = a + np.float32([0.0, 1.0, 0.0])
    bvh = torch_lbvh(a, b, c, np.zeros(n, np.int32))
    o = a + np.float32([0.25, 0.25, 3.0])
    d = np.tile(np.float32([[0.0, 0.0, -1.0]]), (n, 1))
    h = torch_hit(bvh, o, d)
    assert h.hit.all()
    np.testing.assert_allclose(h.t.numpy(), 3.0, rtol=1e-6)
    np.testing.assert_allclose(torch.linalg.norm(h.n, dim=1).numpy(), 1.0,
                               atol=1e-5)


def test_lbvh_rebuild_follows_the_geometry():
    """Rebuilding from deformed vertices moves the hit, as the JAX test's
    jitted rebuild does."""
    tris = jml.make_icosphere(2)
    m = np.zeros(len(tris), np.int32)
    o = np.float32([[0.0, 0.0, 3.0]])
    d = np.float32([[0.0, 0.0, -1.0]])
    for scale, t in ((1.0, 2.0), (1.5, 1.5)):
        v = tris * np.float32(scale)
        h = torch_hit(torch_lbvh(v[:, 0], v[:, 1], v[:, 2], m), o, d)
        assert bool(h.hit[0])
        np.testing.assert_allclose(float(h.t[0]), t, atol=1e-3)


@pytest.mark.parametrize("name", MESH_SCENES)
def test_mesh_scene_tables_equal_jax(name):
    """The builder's tables (its LBVH included) equal the JAX scene's, the
    carry-across rebuilds them, and the soup rebuilds the same LBVH."""
    jsc = jbuilders.SCENE_BUILDERS[name]()
    psc = builders.SCENE_BUILDERS[name]()
    assert jsc.mesh is not None and psc.mesh is not None
    assert psc.mesh_clusters is None and psc.mesh_soup is not None
    flat = flatten_jax_scene(jsc)
    mine = psc.to_numpy()
    assert sorted(mine) == sorted(flat)
    for k in mine:
        assert mine[k].dtype == flat[k].dtype, k
        if k in ("mesh.e1", "mesh.e2", "mesh.n"):
            np.testing.assert_allclose(mine[k], flat[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(mine[k], flat[k], err_msg=k)
    assert psc.any_transparent == jsc.any_transparent
    assert psc.mesh_all_opaque == jsc.mesh_all_opaque
    carried = tables.scene_from_numpy(flat)
    assert carried.mesh_soup is None
    assert_lbvh_equal(carried.mesh, jsc.mesh)
    again = psc.mesh_soup.lbvh()
    for f in FIELDS:
        assert torch.equal(getattr(again, f), getattr(psc.mesh, f)), f


@pytest.mark.parametrize("name", ["bunny", "glass_gem"])
def test_mesh_scene_first_hits_match_jax(name):
    """``intersect_scene`` (primitives, then the BVH sweep clipped to
    them) against the JAX one on the scene's primary rays."""
    jsc = jbuilders.SCENE_BUILDERS[name]()
    psc = builders.SCENE_BUILDERS[name]()
    rs = np.random.RandomState(16)
    o = np.tile(np.float32(psc.defaults[:3]), (1024, 1))
    d = rs.randn(1024, 3).astype(np.float32) * np.float32([0.4, 0.3, 1.0])
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = jintersect.intersect_scene(jsc, jnp.asarray(o), jnp.asarray(d),
                                      1e-3, jintersect.INF)
    got = intersect.intersect_scene(psc, torch.from_numpy(o),
                                    torch.from_numpy(d), 1e-3, intersect.INF)
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    mesh_mat = int(psc.mesh.mat[0])
    assert (got.mat.numpy()[hit] == mesh_mat).sum() > 50
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.mat.numpy()[hit],
                                  np.asarray(want.mat)[hit])
    np.testing.assert_allclose(got.n.numpy()[hit], np.asarray(want.n)[hit],
                               atol=1e-5)
