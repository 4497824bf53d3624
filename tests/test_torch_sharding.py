"""Row sharding of the port (parallel/sharding.py) on the CPU: ranks spawned
by ``sharding.spawn`` with gloo and a FileStore in a temporary directory,
one spawn a test rendering all of its scenes, held to the JAX package's
own sharding contract (tests/test_pipeline.py: top within 2e-5, fg equal
on Cornell and fewer than 0.5% fg flips on the other paths) against the
port's unsharded frame, and to the goldens the JAX package rendered."""

import functools
import os

import numpy as np
import pytest
import torch
from torch.multiprocessing import ProcessRaisedException

from yetanotherconsolegameengine_tpu_torch.parallel import sharding
from yetanotherconsolegameengine_tpu_torch.render.renderer import (
    RaytraceRenderer)
from yetanotherconsolegameengine_tpu_torch.scene.builders import SCENE_BUILDERS
from yetanotherconsolegameengine_tpu_torch.scene.mesh_scenes import (
    FORCED_SCENE_BUILDERS)
from yetanotherconsolegameengine_tpu_torch.scene.voxel_scenes import (
    build_voxel_test_scene)
from yetanotherconsolegameengine_tpu_torch.world.settings import WorldConfig

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens.npz")
# tests/test_torch_world.py's small island.
TINY = WorldConfig(chunks_x=2, chunks_y=1, chunks_z=2, chunk_size=16,
                   view_distance=1, seed=42)


def _unsharded(scenes, w, h, frames, ss=1):
    """The port's single-device frame: ``scenes`` is one scene, or the
    scene of each frame (assigned between frames, the camera at the
    scene's default pose)."""
    scenes = scenes if isinstance(scenes, list) else [scenes] * frames
    r = RaytraceRenderer(scenes[0], w, h, ss=ss, device="cpu")
    out = None
    for scene in scenes:
        if scene is not r.scene:
            r.scene = scene
            d = scene.defaults
            r.set_camera(d[0:3], d[3], d[4])
        out = r.render()
    return out


def _contract(got, want, name, fg_equal=False):
    np.testing.assert_allclose(got["top_rgb"], want.top_rgb.numpy(),
                               atol=2e-5, err_msg=name)
    np.testing.assert_allclose(got["bot_rgb"], want.bot_rgb.numpy(),
                               atol=2e-5, err_msg=name)
    flips = (got["fg_ansi"] != want.fg_ansi.numpy()).mean()
    assert flips == 0.0 if fg_equal else flips < 0.005, (name, flips)
    assert int(got["rays_traced"]) == int(want.rays_traced), name


def test_eight_ranks_match_the_unsharded_frame():
    """8 ranks at 32x16 cells (4 traced rows a band, a 15-row halo over
    four owners each side), 2 frames, on every traversal path: K2's
    primitive tables, the forced cluster mesh, the LBVH teapot and the
    voxel DDA; and Cornell at ss=2 (8-row bands; the tail in torch on
    each band's cells, launch B writing only the exposure)."""
    builds = {"cornell": (SCENE_BUILDERS["cornell"], 1),
              "cornell_ss2": (SCENE_BUILDERS["cornell"], 2),
              "clusters": (functools.partial(sharding.cluster_test_scene, 3),
                           1),
              "teapot": (SCENE_BUILDERS["teapot"], 1),
              "voxels": (functools.partial(build_voxel_test_scene,
                                           merge="dda"), 1)}
    res = sharding.spawn(8, sharding.frames_job,
                         [sharding.FrameJob(k, b, 32, 16, ss=ss)
                          for k, (b, ss) in builds.items()], device="cpu")
    assert len(res) == 8
    for k, (build, ss) in builds.items():
        got = res[0]["frames"][k]
        assert got["top_rgb"].shape == (16, 32, 3)
        assert got["fg_ansi"].shape == (16, 32)
        _contract(got, _unsharded(build(), 32, 16, 2, ss), k,
                  fg_equal=k.startswith("cornell"))
        for r in res[1:]:   # every rank holds the gathered frame
            np.testing.assert_array_equal(r["frames"][k]["fg_ansi"],
                                          got["fg_ansi"])
        assert all(r["launches"][k] == {"trace": 0, "post": 0,
                                        "clusters": 0, "bvh": 0, "dda": 0,
                                        "prim": 0, "cluster_prep": 0,
                                        "cluster_cull": 0,
                                        "cluster_resolve": 0}
                   for r in res)


def test_four_ranks_hold_the_goldens():
    """4 ranks at 48x28 cells (14-row bands), 4 frames, against the JAX
    package's renders within 2e-3."""
    goldens = np.load(GOLDENS)
    builds = {"cornell": SCENE_BUILDERS["cornell"],
              "cluster_forced": FORCED_SCENE_BUILDERS["cluster_forced"],
              "voxel_test": SCENE_BUILDERS["voxel_test"]}
    res = sharding.spawn(4, sharding.frames_job,
                         [sharding.FrameJob(k, b, 48, 28, n_frames=4)
                          for k, b in builds.items()], device="cpu")
    for k in builds:
        got = res[0]["frames"][k]
        for half in ("top", "bot"):
            err = np.abs(got[f"{half}_rgb"] - goldens[f"{k}_{half}"]).max()
            assert err <= 2e-3, (k, half, err)


def test_scene_changed_on_rank_zero_between_steps(tmp_path):
    """A streamed island on the surface path: one ``VolumeScene.update``
    on rank 0 between steps 1 and 2 (lights, sky and the player move),
    broadcast by assigning ``step.scene``, renders as the single-device
    renderer does with the same change."""
    frames = functools.partial(sharding.volume_frames, TINY, dt=0.1,
                               device="cpu")
    job = sharding.FrameJob("island", functools.partial(
        frames, str(tmp_path / "sharded.vg")), 32, 16)
    res = sharding.spawn(4, sharding.frames_job, [job], device="cpu")
    single = frames(str(tmp_path / "single.vg"))
    try:
        scenes = [next(single), next(single)]
    finally:
        single.close()
    assert scenes[0].mesh_clusters is not None
    assert not torch.equal(scenes[0].lights.pos, scenes[1].lights.pos)
    want = _unsharded(scenes, 32, 16, 2)
    _contract(res[0]["frames"]["island"], want, "island")
    # The change moves the frame by far more than the contract's 2e-5.
    unchanged = _unsharded(scenes[0], 32, 16, 2)
    assert np.abs(unchanged.top_rgb.numpy() - want.top_rgb.numpy()).max() \
        > 1e-4


def test_dryrun_and_errors(tmp_path):
    """The reference dryrun's scenes on 2 ranks; a shape the world does
    not divide raises on every rank and so in ``dryrun``; NCCL with more
    ranks than cards raises with the gloo hint."""
    res = sharding.dryrun(2, device="cpu")
    assert len(res) == 2
    assert all(set(r["frames"]) == {"cornell", "mesh_clusters", "voxel_dda"}
               for r in res)
    assert all(f["top_rgb"].shape == (4, 32, 3) and np.isfinite(
        f["top_rgb"]).all() for r in res for f in r["frames"].values())
    with pytest.raises(ProcessRaisedException, match="divisible"):
        sharding.dryrun(2, fb_h=3, device="cpu")
    cards = torch.cuda.device_count()
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        sharding.make_group(0, cards + 1, store, "nccl", "cuda")
    with pytest.raises(ValueError, match="nccl"):
        sharding.make_group(0, 1, store, "nccl", "cpu")


def test_exchange_follows_the_backend():
    """NCCL keeps the exchange on the rank's card and stages nothing; gloo
    exchanges on the host, staging CUDA tensors through pinned buffers."""
    card = torch.device("cuda", 0)
    for dev, backend, exchange, staged in (
            (card, "nccl", card, False), (card, "gloo", "cpu", True),
            (torch.device("cpu"), "gloo", "cpu", False)):
        g = sharding.RowGroup(0, 1, dev, backend)
        assert g.exchange_device == torch.device(exchange)
        assert g.staged is staged


def test_world_one_default_group_round_trips_every_dtype(tmp_path):
    """``make_group``'s default on the CPU (gloo, unstaged: the same code
    path as NCCL's exchange on the card) at world 1: a scene that carries
    every tensor dtype of the shipped scenes (the island's surface clusters,
    a texture bank, LBVH rows and soup, a voxel grid) comes back from
    ``broadcast_scene`` equal, and ``combine`` returns the band's own
    partial, whose exposure is the unsharded frame's (chip_smoke's phase
    23e helpers)."""
    import chip_smoke
    from yetanotherconsolegameengine_tpu_torch.ops import trace_kernel
    from yetanotherconsolegameengine_tpu_torch.world.volume_scene import (
        build_minecraft_like)
    vs = build_minecraft_like(cfg=TINY, world_path=str(tmp_path / "w.vg"),
                              device="cpu")
    try:
        island = vs.update(1 / 30)
    finally:
        vs.manager.shutdown()
    scene = chip_smoke.every_dtype_scene(island, "cpu")
    shipped = set()
    for name, build in SCENE_BUILDERS.items():
        if name != "dragon":
            built = build()
            shipped |= {t.dtype for t in chip_smoke.scene_tensors(
                getattr(built, "base", built)).values()}
    assert shipped <= {t.dtype for t in
                       chip_smoke.scene_tensors(scene).values()}
    inputs = chip_smoke.post_inputs(
        trace_kernel.pack_scene(SCENE_BUILDERS["cornell"]()), 32, 24, "cpu")
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    group = sharding.make_group(0, 1, store, device="cpu")
    try:
        assert (group.backend, group.exchange_device, group.staged) == (
            "gloo", torch.device("cpu"), False)
        trip = chip_smoke.scene_round_trip(group, scene)
        assert {"bool", "float32", "int16", "int32"} <= set(trip["dtypes"])
        got = chip_smoke.combine_check(group, inputs,
                                       chip_smoke.DEFAULT_CONFIG)
        assert got["exposure_err"] <= 1e-5
    finally:
        torch.distributed.destroy_process_group()

