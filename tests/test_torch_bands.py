"""Row bands of a frame (the pieces ``parallel/sharding.py`` runs on each
rank), held on the CPU against the whole frame: the plain trace kernel
and the wavefront on a band are those rows of the full frame bit for bit;
the plain post's band mode (launch A on an extended band, the partials
combined in band order, launch B) gives the full frame's owned rows; the
exposure partials of bands sum to ``update_exposure``; the halo depth
follows the configuration. The first checks run against the JAX package's
own trace for the same band of rows."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from yetanotherconsolegameengine_tpu_torch.config import DEFAULT_CONFIG
from yetanotherconsolegameengine_tpu_torch.core.camera import (
    make_jittered_rays, ray_params)
from yetanotherconsolegameengine_tpu_torch.ops import post_kernel, tonemap
from yetanotherconsolegameengine_tpu_torch.ops import trace_kernel
from yetanotherconsolegameengine_tpu_torch.parallel.sharding import (
    RowShard, check_shape, cluster_test_scene)
from yetanotherconsolegameengine_tpu_torch.render.renderer import (
    trace_wavefront_planes)
from yetanotherconsolegameengine_tpu_torch.scene.builders import SCENE_BUILDERS
from yetanotherconsolegameengine_tpu_torch.scene.voxel_scenes import (
    build_voxel_test_scene)

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

W, H = 32, 40
BANDS = [(0, 5), (5, 12), (12, 27), (27, 40)]
CFG = DEFAULT_CONFIG


def _params(scene, w, h, frame):
    return ray_params(scene.default_pose, w, h, frame)


@pytest.mark.parametrize("name", ["cornell", "glass", "mirror_spheres"])
def test_trace_planes_plain_on_a_band_is_the_full_frame_rows(name):
    scene = SCENE_BUILDERS[name]()
    p = _params(scene, W, H, 3)
    full = trace_kernel.trace_planes_plain(scene, p, 3, W, H, CFG)
    for y0, y1 in BANDS:
        band = trace_kernel.trace_planes_plain(scene, p, 3, W, H, CFG,
                                               (y0, y1))
        assert band.shape == (12, y1 - y0, W)
        assert torch.equal(band, full[:, y0:y1]), (y0, y1)
    # On the CPU the wrapper runs the plain version, bands included.
    packed = trace_kernel.pack_scene(scene)
    frames = torch.tensor([3], dtype=torch.int32)
    assert torch.equal(trace_kernel.trace_planes(
        packed, p[None], frames, 0, W, H, CFG, (5, 12)), full[:, 5:12])


def test_band_rays_are_the_frame_rows():
    """A band's jittered rays are those rows of the port's frame bit for
    bit, and of the JAX package's within 1e-6 (tests/test_torch_core.py's
    tolerance: XLA contracts the screen coordinate differently)."""
    import jax.numpy as jnp

    from yetanotherconsolegameengine_tpu.core import camera as jcamera
    scene = SCENE_BUILDERS["cornell"]()
    p = _params(scene, W, H, 3)
    fo, fd = make_jittered_rays(None, W, H, 3, params=p)
    jo, jd = jcamera.make_jittered_rays(None, W, H, 3,
                                        params=jnp.asarray(p.numpy()))
    for y0, y1 in BANDS:
        o, d = make_jittered_rays(None, W, H, 3, params=p, rows=(y0, y1))
        assert torch.equal(o, fo[y0:y1]) and torch.equal(d, fd[y0:y1])
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo)[y0:y1])
        np.testing.assert_allclose(d.numpy(), np.asarray(jd)[y0:y1],
                                   atol=1e-6)


@pytest.mark.parametrize("name", ["teapot", "voxel_dda", "clusters"])
def test_wavefront_on_a_band_is_the_full_frame_rows(name):
    """The wavefront (the BVH walk, the DDA, and the cluster sweeps in
    16x16 block order with each band padded to 16 rows) on a band."""
    scene = {"teapot": SCENE_BUILDERS["teapot"],
             "voxel_dda": functools.partial(build_voxel_test_scene,
                                            merge="dda"),
             "clusters": functools.partial(cluster_test_scene, 3)}[name]()
    p = _params(scene, W, H, 2)
    full = trace_wavefront_planes(scene, p, 2, W, H, CFG)
    for y0, y1 in BANDS:
        band = trace_wavefront_planes(scene, p, 2, W, H, CFG, rows=(y0, y1))
        assert torch.equal(band, full[:, y0:y1]), (y0, y1)


def _post_inputs(w, h, seed=0):
    scene = SCENE_BUILDERS["cornell"]()
    cur, prev = (trace_kernel.trace_planes_plain(
        scene, _params(scene, w, h, f), f, w, h, CFG) for f in (3, 2))
    rs = np.random.RandomState(seed)
    hist = cur[0:3] * torch.from_numpy(
        rs.uniform(0.8, 1.25, (3, h, w)).astype(np.float32))
    return cur, prev, hist.contiguous()


def _banded_post(cur, prev, hist, world, ss, cfg, fuse_tail, halo=None,
                 valid=True):
    """Post a (12, h, w) frame as ``world`` row bands with ``halo`` rows
    each side (default: halo_rows(cfg)), as the sharded step does; returns
    the bands' outputs stacked by rows and the new exposure."""
    h = cur.shape[1]
    fb_h = h // (2 * ss)
    step = max(2, 2 * ss)
    ae = torch.tensor(0.8)
    flags = torch.tensor(valid), torch.tensor(False)
    parts, outs = [], []
    for r in range(world):
        shard = RowShard.of(r, world, fb_h, ss, cfg)
        if halo is not None:
            shard = dataclasses.replace(shard, halo=halo)
        e0, e1 = shard.ext
        blended, denoised, part = post_kernel.post_band_plain(
            cur[:, e0:e1], prev[:, e0:e1], hist[:, e0:e1], *flags, cfg, step,
            e0, shard.own)
        assert blended.shape == (3, shard.y1 - shard.y0, cur.shape[2])
        parts.append(part)
        outs.append((blended, denoised))
    total = post_kernel.combine_partials(torch.stack(parts))
    res = []
    for blended, denoised in outs:
        img, idx, new_ae = post_kernel.post_band_tail_plain(
            denoised, total, ae, cfg, fuse_tail)
        res.append((blended, denoised, img, idx))
    cat = lambda k: (None if res[0][k] is None
                     else torch.cat([x[k] for x in res], dim=-2))
    return cat(0), cat(1), cat(2), cat(3), new_ae


@pytest.mark.parametrize("world,ss", [(4, 1), (10, 1), (2, 2)])
def test_post_band_mode_is_the_full_frame_rows(world, ss):
    """Bands of 10, 4 and 20 rows with 15 halo rows: halos over several
    owners. Blended and denoised within 1e-6 (the same per-pixel
    arithmetic on other tensor shapes), ANSI equal, the exposure from the
    combined partials within 1e-6."""
    cur, prev, hist = _post_inputs(W, H)
    ae = torch.tensor(0.8)
    flags = torch.tensor(True), torch.tensor(False)
    step = max(2, 2 * ss)
    for fuse_tail in (True, False):
        blended, img, idx, want_ae = post_kernel.post_plain(
            cur, prev, hist, *flags, ae, CFG, step, fuse_tail)
        _, denoised, _, _ = post_kernel.post_plain(
            cur, prev, hist, *flags, ae, CFG, step, False)
        b, d, m, i, got_ae = _banded_post(cur, prev, hist, world, ss, CFG,
                                          fuse_tail)
        np.testing.assert_allclose(b.numpy(), blended.numpy(), atol=1e-6)
        np.testing.assert_allclose(d.numpy(), denoised.numpy(), atol=1e-6)
        assert abs(float(got_ae) - float(want_ae)) <= 1e-6
        if fuse_tail:
            np.testing.assert_allclose(m.numpy(), img.numpy(), atol=1e-5)
            np.testing.assert_array_equal(i.numpy(), idx.numpy())
        else:
            assert i is None and torch.equal(m, d)


def test_post_band_mode_resets_history_like_the_full_frame():
    cur, prev, hist = _post_inputs(W, H, seed=1)
    ae = torch.tensor(0.8)
    blended, _, idx, _ = post_kernel.post_plain(
        cur, prev, hist, torch.tensor(False), torch.tensor(False), ae, CFG,
        2, True)
    b, _, _, i, _ = _banded_post(cur, prev, hist, 4, 1, CFG, True,
                                 valid=False)
    np.testing.assert_allclose(b.numpy(), blended.numpy(), atol=1e-6)
    np.testing.assert_array_equal(b.numpy(), cur[0:3].numpy())
    np.testing.assert_array_equal(i.numpy(), idx.numpy())


@pytest.mark.parametrize("step", [2, 4])
def test_exposure_partials_of_bands_sum_to_update_exposure(step):
    rs = np.random.RandomState(step)
    hdr = torch.from_numpy(np.exp(rs.normal(-1.0, 1.0, (37, 29, 3)))
                           .astype(np.float32))
    sky = torch.from_numpy(rs.uniform(size=(37, 29)) < 0.2)
    ae = torch.tensor(0.7)
    want, want_eff = tonemap.update_exposure(hdr, sky, ae, CFG, step)
    # Band starts 0, 3, 7, 18, 19: not multiples of the step.
    cuts = [0, 3, 7, 18, 19, 37]
    parts = [tonemap.exposure_partials(hdr[a:b], sky[a:b], step, a)
             for a, b in zip(cuts, cuts[1:])]
    count = sum(int(c) for _, c in parts)
    full_sum, full_count = tonemap.exposure_partials(hdr, sky, step)
    assert count == int(full_count)
    total = post_kernel.combine_partials(torch.stack(
        [torch.stack([s, c.to(torch.float32)]) for s, c in parts]))
    assert abs(float(total[0]) - float(full_sum)) <= 1e-4
    got, got_eff = tonemap.exposure_from_partials(total[0], total[1], ae, CFG)
    assert abs(float(got) - float(want)) <= 1e-6
    assert abs(float(got_eff) - float(want_eff)) <= 1e-6
    off = dataclasses.replace(CFG, auto_exposure=False)
    assert float(tonemap.exposure_from_partials(total[0], total[1], ae,
                                                off)[0]) == float(ae)


def test_halo_depth_follows_the_configuration():
    """halo_rows = taa_clamp_radius + 2 * (1 + 2 + ... + 2^(n-1)); with
    that halo a band posts the full frame's rows, with one row fewer it
    does not."""
    assert post_kernel.halo_rows(CFG) == 15 == 1 + 2 * (1 + 2 + 4)
    cfg = dataclasses.replace(CFG, taa_clamp_radius=2, atrous_iterations=2)
    assert post_kernel.halo_rows(cfg) == 2 + 2 * (1 + 2)
    assert post_kernel.halo_rows(
        dataclasses.replace(CFG, atrous_iterations=4)) == 1 + 2 * 15
    shard = RowShard.of(2, 4, 20, 1, cfg)
    assert (shard.y0, shard.y1, shard.halo, shard.ext, shard.own) == (
        20, 30, 8, (12, 38), (8, 18))
    cur, prev, hist = _post_inputs(W, H)
    blended, denoised, _, _ = post_kernel.post_plain(
        cur, prev, hist, torch.tensor(True), torch.tensor(False),
        torch.tensor(0.8), cfg, 2, False)
    b, d, _, _, _ = _banded_post(cur, prev, hist, 4, 1, cfg, False)
    np.testing.assert_allclose(d.numpy(), denoised.numpy(), atol=1e-6)
    _, d_short, _, _, _ = _banded_post(cur, prev, hist, 4, 1, cfg, False,
                                       halo=post_kernel.halo_rows(cfg) - 1)
    assert np.abs(d_short.numpy() - denoised.numpy()).max() > 1e-6


def test_band_shapes_must_divide():
    check_shape(8, 16, 1)
    check_shape(4, 28, 2)
    for world, fb_h in ((3, 16), (8, 12), (5, 28)):
        with pytest.raises(ValueError, match="divisible"):
            check_shape(world, fb_h)
    with pytest.raises(ValueError, match="rows"):
        trace_kernel.trace_planes_plain(
            SCENE_BUILDERS["cornell"](), torch.zeros(18), 1, W, H, CFG,
            (30, 41))
