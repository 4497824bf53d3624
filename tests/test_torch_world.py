"""The port's streamed world (world/) against the JAX package's: the copied
worldgen and VG01 files equal bit for bit, the chunk manager's streaming,
recentring, cache and window (its encoded cells equal to the JAX
manager's), streaming past a source that fails every other chunk, and
the player physics with the fail-safe teleport. Every manager runs its
worker threads on a small world and is shut down in a ``finally``; waits
go through ``ensure_all_loaded(timeout=)`` or a deadline of the test's
own."""

import time

import numpy as np
import pytest
import torch

from yetanotherconsolegameengine_tpu.world import genmath as jgen
from yetanotherconsolegameengine_tpu.world import worldgen as jworldgen
from yetanotherconsolegameengine_tpu.world.manager import (
    WorldManager as JWorldManager)
from yetanotherconsolegameengine_tpu.world.persistence import (
    save_world as jsave_world)
from yetanotherconsolegameengine_tpu_torch.world import (biome, genmath,
                                                         rivers, terrain,
                                                         worldgen)
from yetanotherconsolegameengine_tpu_torch.world.manager import WorldManager
from yetanotherconsolegameengine_tpu_torch.world.persistence import (
    WorldFile, load_world, save_world)
from yetanotherconsolegameengine_tpu_torch.world.settings import (
    IslandSettings, WorldConfig, WorldGenSettings)

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

TINY = WorldConfig(chunks_x=2, chunks_y=1, chunks_z=2, chunk_size=16,
                   view_distance=1, seed=42)


def _jcfg(cfg):
    from yetanotherconsolegameengine_tpu.world.settings import WorldConfig as J
    return J(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})


def test_generate_world_equals_jax(tmp_path):
    """The golden's 2x2x2-chunk island and a 16-voxel-chunk world: every
    array equal, the VG01 files byte for byte, and a chunk read back."""
    for cfg in (WorldConfig(chunks_x=2, chunks_y=2, chunks_z=2,
                            view_distance=1), TINY):
        blocks, meta = worldgen.generate_world(cfg)
        jb, jm = jworldgen.generate_world(_jcfg(cfg))
        for got, want in ((blocks, jb), (meta, jm)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert (blocks != 0).any() and (blocks == 0).any()
        save_world(str(tmp_path / "p.vg"), blocks, meta)
        jsave_world(str(tmp_path / "j.vg"), jb, jm)
        assert ((tmp_path / "p.vg").read_bytes()
                == (tmp_path / "j.vg").read_bytes())
        b2, m2 = load_world(str(tmp_path / "p.vg"))
        np.testing.assert_array_equal(b2, blocks)
        np.testing.assert_array_equal(m2, meta)
        wf = WorldFile(str(tmp_path / "p.vg"))
        try:
            cb, _ = wf.read_chunk(16, 0, 0, 16)
            np.testing.assert_array_equal(cb, blocks[16:32, :16, :16])
        finally:
            wf.close()


def test_worldgen_stages_equal_jax():
    """Noise, terrain, rivers and biomes, stage by stage, on one grid."""
    xx, zz = np.meshgrid(np.linspace(-40, 40, 48), np.linspace(-40, 40, 48))
    for name in ("gradient_noise_2d", "fbm2d", "ridged_fbm2d"):
        np.testing.assert_array_equal(getattr(genmath, name)(xx, zz, seed=7),
                                      getattr(jgen, name)(xx, zz, seed=7))
    s, gs = IslandSettings(), WorldGenSettings(river_min_accum=8.0)
    hy = terrain.height_y(xx + 16, zz + 16, TINY, s)
    from yetanotherconsolegameengine_tpu.world import terrain as jterrain
    np.testing.assert_array_equal(hy, jterrain.height_y(
        xx + 16, zz + 16, _jcfg(TINY), s))
    from yetanotherconsolegameengine_tpu.world import rivers as jrivers
    for got, want in zip(rivers.carve(hy * 1.0, gs),
                         jrivers.carve(hy * 1.0, gs)):
        np.testing.assert_array_equal(got, want)
    from yetanotherconsolegameengine_tpu.world import biome as jbiome
    wy = np.full_like(hy, 10)
    np.testing.assert_array_equal(
        biome.evaluate(xx, zz, hy, wy, TINY, gs),
        jbiome.evaluate(xx, zz, hy, wy, _jcfg(TINY), gs))


def _lut():
    lut = np.zeros((12, 5), np.int16)
    for b in range(1, 12):
        for m in range(5):
            lut[b, m] = b * 5 + m
    return lut


def _managers(tmp_path, cfg):
    blocks, meta = worldgen.generate_world(cfg)
    p = str(tmp_path / "w.vg")
    save_world(p, blocks, meta)
    from yetanotherconsolegameengine_tpu.world.persistence import (
        WorldFile as JWorldFile)
    mgr = WorldManager(cfg, _lut(), WorldFile(p), n_workers=2, device="cpu")
    jmgr = JWorldManager(_jcfg(cfg), _lut(), JWorldFile(p), n_workers=2)
    return mgr, jmgr, blocks


def test_manager_streams_and_recenters_like_jax(tmp_path):
    """A wide world: the desired set streams in, the window's encoded cells
    equal the JAX manager's, a two-chunk walk recentres and uploads fresh
    chunks, and walking back serves evicted chunks from the cache."""
    cfg = WorldConfig(chunks_x=6, chunks_y=1, chunks_z=2, chunk_size=16,
                      view_distance=1, seed=42)
    mgr, jmgr, blocks = _managers(tmp_path, cfg)
    try:
        for pos in ((8.0, 0.0, 8.0), (8.0 + 2.5 * 16, 0.0, 8.0)):
            mgr.ensure_all_loaded(pos, timeout=30.0)
            jmgr.ensure_all_loaded(pos, timeout=30.0)
            assert mgr._loaded == jmgr._loaded
            np.testing.assert_array_equal(mgr._host, jmgr._host)
            vw, jvw = mgr.voxel_world(), jmgr.voxel_world()
            np.testing.assert_array_equal(vw.cells.numpy(),
                                          np.asarray(jvw.cells))
            np.testing.assert_array_equal(vw.origin.numpy(),
                                          np.asarray(jvw.origin))
        assert mgr.stats["recenters"] >= 1 and mgr.stats["uploads"] > 3
        ox, _, oz = mgr._window_origin_vox()
        key = sorted(mgr._loaded)[0]
        got = mgr._host[key[0] * 16 - ox:(key[0] + 1) * 16 - ox, 0:16,
                        key[2] * 16 - oz:(key[2] + 1) * 16 - oz]
        want = blocks[key[0] * 16:(key[0] + 1) * 16, 0:16,
                      key[2] * 16:(key[2] + 1) * 16]
        np.testing.assert_array_equal(got != 0, want != 0)
        mgr.ensure_all_loaded((8.0, 0.0, 8.0), timeout=30.0)
        jmgr.ensure_all_loaded((8.0, 0.0, 8.0), timeout=30.0)
        assert mgr.stats["cache_hits"] > 0
        np.testing.assert_array_equal(mgr._host, jmgr._host)
        # Physics queries read the host mirror.
        cols = np.argwhere((blocks[:32, :, :32] != 0).any(1))
        x, z = (float(v) + 0.5 for v in cols[len(cols) // 2])
        g = mgr.ground_height(x, z, float(cfg.world_y))
        assert g is not None
        assert g == jmgr.ground_height(x, z, float(cfg.world_y))
        assert mgr.sample_cell(x, g - 0.5, z) != 0
        assert mgr.sample_cell(x, g + 0.5, z) == 0
    finally:
        mgr.shutdown()
        jmgr.shutdown()
    assert not any(w.is_alive() for w in mgr._workers)


def test_volume_scene_physics_and_failsafe(tmp_path):
    """Spawned on the ground; a drop from the air lands; the day cycle
    swaps finite lights into the scene on the manager's device; a fall far
    below the world teleports the player back above it."""
    from yetanotherconsolegameengine_tpu_torch.world.volume_scene import (
        EYE_HEIGHT, build_minecraft_like)

    vs = build_minecraft_like(cfg=TINY, world_path=str(tmp_path / "p.vg"),
                              device="cpu")
    try:
        g0 = vs.manager.ground_height(vs.pos[0], vs.pos[2],
                                      float(TINY.world_y))
        assert abs(vs.pos[1] - (g0 + EYE_HEIGHT)) < 0.5
        vs.pos[1] += 5.0
        vs.on_ground = False
        for _ in range(200):
            vs.update(1 / 30)
            if vs.on_ground:
                break
        assert vs.on_ground
        assert abs(vs._feet() - vs._ground_probe()) < 1e-3
        scene = vs.update(1 / 30)
        assert scene.mesh_clusters is not None and scene.voxels is None
        assert torch.isfinite(scene.lights.intensity).all()
        assert scene.lights.pos.device == scene.device
        vs.pos[1] = TINY.world_min_y - 200.0
        vs.vel[1] = -50.0
        vs.update(1 / 30)
        assert vs.pos[1] > TINY.world_min_y - 50.0
    finally:
        vs.manager.shutdown()


def test_forced_dda_island_carries_the_window(tmp_path):
    """``surface_mesh=False``: the frame's scene holds the encoded window
    as its voxel grid, with binary shadows."""
    from yetanotherconsolegameengine_tpu_torch.world.volume_scene import (
        build_minecraft_like)

    vs = build_minecraft_like(cfg=TINY, world_path=str(tmp_path / "p.vg"),
                              surface_mesh=False, device="cpu")
    try:
        scene = vs.update(1 / 30)
        assert scene.mesh_clusters is None and scene.binary_shadows
        assert scene.voxels.dims == (48, 16, 48)
        assert int((scene.voxels.cells > 0).sum()) == int(
            (vs.manager._host > 0).sum())
    finally:
        vs.manager.shutdown()


def test_worker_exception_does_not_kill_streaming():
    """tests/test_failure_modes.py's scenario on the port's manager: a
    source that raises on every other chunk leaves the desired set
    unsatisfied, and re-requesting retries the failed chunks until it is
    loaded, within 30 s."""
    calls = {"n": 0}

    def flaky_source(cx, cy, cz):
        calls["n"] += 1
        if calls["n"] % 2 == 1:  # every other chunk build crashes
            raise RuntimeError("injected fault")
        C = TINY.chunk_size
        blocks = np.ones((C, C, C), np.int32)
        return blocks, np.zeros_like(blocks)

    mgr = WorldManager(TINY, _lut(), flaky_source, n_workers=2, device="cpu")
    try:
        deadline = time.time() + 30.0
        while time.time() < deadline:
            mgr.load_chunks_around((16.0, 0.0, 16.0))
            mgr.drain_ready(max_chunks=64)
            with mgr._desired_lock:
                if mgr._desired <= mgr._loaded:
                    break
            time.sleep(0.01)
        with mgr._desired_lock:
            assert mgr._desired and mgr._desired <= mgr._loaded
        assert calls["n"] > 4  # retries happened
    finally:
        mgr.shutdown()
    assert not any(w.is_alive() for w in mgr._workers)


def test_entry_points_default_to_the_card(tmp_path):
    """Without a card the streamed world's entry points raise rather than
    fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from yetanotherconsolegameengine_tpu_torch.world.surface import (
        SurfaceClusterTable)
    from yetanotherconsolegameengine_tpu_torch.world.volume_scene import (
        build_minecraft_like)
    with pytest.raises(RuntimeError, match="CUDA"):
        SurfaceClusterTable(4, np.zeros((2, 3), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_minecraft_like(cfg=TINY, world_path=str(tmp_path / "p.vg"))
