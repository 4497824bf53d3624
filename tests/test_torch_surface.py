"""The port's streamed-world surface (world/surface.py) against the JAX
package's: greedy chunk meshing and pooling equal, ``SurfaceClusterTable``
rows and slots equal after add, update, evict and overflow, the island's
full and LOD tables equal, the cluster sweep's winners on the island equal
to the JAX kernel's (shared edges of coplanar quads included), free rows
never listed, and the surface image equal to the DDA image of the same
opaque grid."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yetanotherconsolegameengine_tpu.ops import mesh_clusters as jmc
from yetanotherconsolegameengine_tpu.world import surface as jsurf
from yetanotherconsolegameengine_tpu_torch.core.camera import (
    CameraPose, make_jittered_rays, ray_params)
from yetanotherconsolegameengine_tpu_torch.ops import mesh_clusters as pmc
from yetanotherconsolegameengine_tpu_torch.ops.dda import build_voxel_world
from yetanotherconsolegameengine_tpu_torch.render.renderer import (
    RaytraceRenderer)
from yetanotherconsolegameengine_tpu_torch.scene.materials import Material
from yetanotherconsolegameengine_tpu_torch.scene.tables import SceneBuilder
from yetanotherconsolegameengine_tpu_torch.world import surface as psurf
from yetanotherconsolegameengine_tpu_torch.world.settings import WorldConfig

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

WB = np.array([[0, 0, 0], [64, 64, 64]], np.float32)
KC = pmc.KC


def _pad(core):
    p = np.zeros(tuple(s + 2 for s in core.shape), np.int16)
    p[1:-1, 1:-1, 1:-1] = core
    return p


def _cores():
    rng = np.random.default_rng(11)
    rand = ((rng.random((8, 8, 8)) < 0.4)
            * rng.integers(1, 4, (8, 8, 8))).astype(np.int16)
    water = np.zeros((4, 4, 4), np.int16)
    water[1, 0, 1], water[1, 1:3, 1] = 2, 5
    checker = np.zeros((8, 8, 8), np.int16)
    checker[:, 0, :] = np.where(np.add.outer(np.arange(8), np.arange(8)) % 2,
                                3, 4)
    merge = np.arange(16, dtype=np.int16)
    merge[4] = 3
    transparent = np.zeros(16, bool)
    transparent[5] = True
    return [(rand, transparent, None), (water, transparent, None),
            (checker, transparent, merge), (checker, transparent, None)]


@pytest.mark.parametrize("case", range(4))
def test_greedy_mesh_and_pooling_equal_jax(case):
    core, transparent, merge = _cores()[case]
    args = (_pad(core), transparent, (3, 0, 5), 0.5)
    got = psurf.greedy_mesh_chunk(*args, merge_lut=merge)
    want = jsurf.greedy_mesh_chunk(*args, merge_lut=merge)
    assert got[0].shape[0] > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        psurf.pool_cells(core, 2, merge_lut=merge),
        jsurf.pool_cells(core, 2, merge_lut=merge))


def _rows_equal(tbl, jtbl):
    mc, jm = tbl.clusters(), jtbl.clusters()
    for f in ("cbmin", "cbmax", "tri_rows", "bounds"):
        np.testing.assert_array_equal(getattr(mc, f).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    np.testing.assert_array_equal(mc.gmat.numpy(),
                                  pmc.gmat_from_jax(np.asarray(jm.gmat)))
    assert tbl._slots == jtbl._slots and tbl._free == jtbl._free
    assert (tbl.n_used, tbl.overflowed) == (jtbl.n_used, jtbl.overflowed)


def _quads(n, shift):
    rng = np.random.RandomState(n)
    a = rng.uniform(0, 60, (n, 3)).astype(np.float32) + shift
    return (np.stack([a, a + np.float32([1, 0, 0]),
                      a + np.float32([0, 1, 0])], 1),
            rng.randint(1, 9, n).astype(np.int32))


@pytest.mark.parametrize("cap", [8, 3])
def test_surface_table_rows_equal_jax(cap):
    """Add two chunks, shrink one, grow another, evict one: the same rows
    land in the same slots, free rows are degenerate, and a table too
    small counts its overflow."""
    tbl = psurf.SurfaceClusterTable(cap, WB, t_bias=0.5, device="cpu")
    jtbl = jsurf.SurfaceClusterTable(cap, WB, t_bias=0.5)
    steps = [[((0, 0, 0), *_quads(KC + 7, 0.0)),
              ((1, 0, 0), *_quads(40, 1.0))],
             [((0, 0, 0), *_quads(30, 2.0))],
             [((1, 0, 0), *_quads(2 * KC + 1, 3.0)),
              ((0, 1, 0), *_quads(5, 4.0))]]
    for items in steps:
        tbl.update_chunks(items)
        jtbl.update_chunks(items)
        _rows_equal(tbl, jtbl)
    tbl.remove_chunks([(1, 0, 0)])
    jtbl.remove_chunks([(1, 0, 0)])
    _rows_equal(tbl, jtbl)
    assert (tbl.overflowed > 0) == (cap == 3)
    free = tbl.clusters().cbmin[:, 0] >= 1e29
    assert int(free.sum()) == cap - tbl.n_used


def test_free_rows_are_never_listed():
    """The interval cull rejects degenerate rows for every ray, inside and
    outside the world bounds, without a NaN."""
    tbl = psurf.SurfaceClusterTable(6, WB, device="cpu")
    tbl.update_chunks([((0, 0, 0), *_quads(KC + 3, 0.0))])
    mc = tbl.clusters()
    rng = np.random.RandomState(0)
    o = torch.from_numpy(rng.uniform(-20, 80, (1, 256, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(1, 256, 3)).astype(np.float32))
    d[0, :8] = torch.tensor([0.0, 0.0, 1.0])
    ids, entry_t, lens = pmc._tile_cull(o, d, torch.ones(1, 256, dtype=bool),
                                        torch.full((1, 256), 1e9),
                                        mc.cbmin, mc.cbmax)
    listed = set(ids[0, : int(lens[0])].tolist())
    assert listed <= set(tbl._slots[(0, 0, 0)]) and len(listed) > 0
    assert not torch.isnan(entry_t).any()


@pytest.fixture(scope="module")
def islands(tmp_path_factory):
    """The golden's 2x2x2-chunk island, built by both packages, after one
    update: (JAX scene, port scene, spawn)."""
    from yetanotherconsolegameengine_tpu.world.settings import (
        WorldConfig as JConfig)
    from yetanotherconsolegameengine_tpu.world.volume_scene import (
        build_minecraft_like as jbuild)
    from yetanotherconsolegameengine_tpu_torch.world.volume_scene import (
        build_minecraft_like)
    td = str(tmp_path_factory.mktemp("island"))
    out = []
    for build, cfg, kw in ((jbuild, JConfig, {}),
                           (build_minecraft_like, WorldConfig,
                            dict(device="cpu"))):
        vs = build(cfg(chunks_x=2, chunks_y=2, chunks_z=2, view_distance=1),
                   world_path=os.path.join(td, f"{len(out)}.vg"),
                   regenerate=True, **kw)
        try:
            vs.manager.ensure_all_loaded(vs.pos, timeout=60.0)
            out.append(vs.update(1.0 / 30.0))
            assert vs.manager._surface.overflowed == 0
        finally:
            vs.manager.shutdown()
    return out[0], out[1], vs.pos.copy()


def test_island_tables_equal_jax(islands):
    jsc, psc, _ = islands
    for name in ("mesh_clusters", "mesh_clusters_lod"):
        mc, jm = getattr(psc, name), getattr(jsc, name)
        for f in ("cbmin", "cbmax", "tri_rows", "bounds"):
            np.testing.assert_array_equal(getattr(mc, f).numpy(),
                                          np.asarray(getattr(jm, f)))
        np.testing.assert_array_equal(mc.gmat.numpy(),
                                      pmc.gmat_from_jax(np.asarray(jm.gmat)))
        assert mc.t_bias == jm.t_bias
    assert psc.mesh_clusters.n_clusters == 1536
    assert psc.mesh_clusters_lod.n_clusters == 256
    assert not psc.mesh_all_opaque and psc.binary_shadows


def test_island_winners_equal_the_jax_kernel(islands):
    """Primary rays of the golden's view through the island's surface
    tables: the sweep (its plain version) against the JAX kernel in
    interpret mode. Coplanar quads of different blocks share edges, where
    the winner follows the list order, as in the JAX kernel."""
    jsc, psc, pos = islands
    pose = CameraPose.create((float(pos[0]), float(pos[1]) + 10.0,
                              float(pos[2])), 0.0, -0.9, 60.0, device="cpu")
    o, d = (x.reshape(-1, 3) for x in make_jittered_rays(
        None, 48, 56, 1, params=ray_params(pose, 48, 56, 1)))
    want = jmc.intersect_clusters(
        jsc.mesh_clusters, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.full(o.shape[0], 1e-3), jnp.full(o.shape[0], 3e38),
        interpret=True)
    got = pmc.intersect_clusters(psc.mesh_clusters, o, d, 1e-3, 3e38,
                                 impl="plain")
    hit = np.asarray(want.hit)
    assert hit.sum() > 1000
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.mat.numpy()[hit],
                                  np.asarray(want.mat)[hit])
    np.testing.assert_array_equal(got.n.numpy()[hit],
                                  np.asarray(want.n)[hit])
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-5)


def test_surface_render_matches_dda():
    """An opaque grid traced as surface clusters and as a DDA grid: the
    same entry faces give the same image but for grazing pixels."""
    rng = np.random.default_rng(3)
    core = np.zeros((12, 12, 12), np.int16)
    hills = (4 + 4 * rng.random((12, 12))).astype(int)
    for x in range(12):
        for z in range(12):
            core[x, :hills[x, z], z] = 1 + (x + z) % 3
    s = SceneBuilder("surf_eq")
    bank_of = np.zeros(4, np.int16)
    for b, rgb in ((1, (0.8, 0.3, 0.2)), (2, (0.2, 0.7, 0.3)),
                   (3, (0.3, 0.3, 0.9))):
        bank_of[b] = s.bank.add(Material.solid(rgb))
    s.add_light((6.0, 30.0, 6.0), (1, 1, 1), 400.0)
    s.binary_shadows = True
    sc = s.build()
    cells = bank_of[core]
    tris, mats = psurf.greedy_mesh_chunk(_pad(cells), np.zeros(16, bool),
                                         (0, 0, 0), 1.0)
    tbl = psurf.SurfaceClusterTable(
        16, np.array([[0, 0, 0], [12, 12, 12]], np.float32), device="cpu")
    tbl.update_chunks([((0, 0, 0), tris, mats)])
    imgs = []
    for scene in (dataclasses.replace(sc, voxels=build_voxel_world(
                      cells, (0.0, 0.0, 0.0), 1.0, device="cpu")),
                  dataclasses.replace(sc, mesh_clusters=tbl.clusters())):
        r = RaytraceRenderer(scene, 48, 24, device="cpu")
        r.set_camera([6.0, 14.0, -6.0], np.pi, -0.9)
        imgs.append(r.render().top_rgb.numpy())
    diff = np.abs(imgs[0] - imgs[1])
    assert np.isfinite(imgs[0]).all() and imgs[0].std() > 1e-2
    assert (diff > 0.02).mean() < 0.02, float(diff.max())
