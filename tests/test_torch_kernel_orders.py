"""The post kernel's (K1) order of work, held on the CPU through numpy
models of what ``ops/csrc/post_kernel.cu`` does, and the trace kernel's
(K2) shared-memory check.

K1: the output tiles cover every pixel once and each staging window holds
every tap of its tile; the exposure is a fixed-order sum of per-tile
partials, which must stay within 1e-5 of ``tonemap.update_exposure``; a
row band's launch A partial covers its owned rows on the whole frame's
sample grid, as ``tonemap.exposure_partials`` does."""

import dataclasses

import numpy as np
import pytest
import torch

from yetanotherconsolegameengine_tpu_torch.config import DEFAULT_CONFIG
from yetanotherconsolegameengine_tpu_torch.core.camera import ray_params
from yetanotherconsolegameengine_tpu_torch.ops import (post_kernel, tonemap,
                                                       trace_kernel)
from yetanotherconsolegameengine_tpu_torch.ops.taa import luma
from yetanotherconsolegameengine_tpu_torch.scene.builders import SCENE_BUILDERS

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)


def test_trace_shared_memory_check():
    """The trace kernel's table and path stack fit for the shipped scenes
    at the deepest stack the card tests use, and a table too large raises
    with its size."""
    for name in ("cornell", "glass", "mirror_spheres"):
        packed = trace_kernel.pack_scene(SCENE_BUILDERS[name]())
        trace_kernel.check_shared(packed.table.numel(), 16)
    assert trace_kernel.shared_bytes(163, 3) == 4 * (32 + 163 + 128 * 3 * 11)
    with pytest.raises(ValueError, match="240000 bytes"):
        trace_kernel.check_shared(60_000, 3)


# ---- K1: tiles, windows and the exposure sum --------------------------------
SIZES = [(23, 37), (180, 160), (270, 240), (1, 1), (17, 33), (720, 1280)]


@pytest.mark.parametrize("h,w", SIZES)
def test_tiles_cover_every_pixel_once(h, w):
    ny, nx = post_kernel.tiles(h, w)
    count = np.zeros((h, w), np.int32)
    for k in range(ny * nx):
        y0, y1, x0, x1 = post_kernel.tile_window(k, h, w, 0)
        count[y0:y1, x0:x1] += 1
    np.testing.assert_array_equal(count, 1)
    assert post_kernel.scratch_floats(h, w) == 16 * h * w + 2 * ny * nx


@pytest.mark.parametrize("halo", [1, 2, 4, 8, 15])
@pytest.mark.parametrize("h,w", SIZES[:5])
def test_windows_hold_every_tap(h, w, halo):
    """Each tap of a tile's pixel, its index clamped to the image first,
    lies in the tile's window of that halo, and the window lies in the
    image."""
    ny, nx = post_kernel.tiles(h, w)
    for k in range(ny * nx):
        ty0, ty1, tx0, tx1 = post_kernel.tile_window(k, h, w, 0)
        y0, y1, x0, x1 = post_kernel.tile_window(k, h, w, halo)
        assert 0 <= y0 <= ty0 < ty1 <= y1 <= h and 0 <= x0 <= tx0 < tx1 <= x1 <= w
        for o in (-halo, halo):
            assert y0 <= np.clip(ty0 + o, 0, h - 1) < y1
            assert y0 <= np.clip(ty1 - 1 + o, 0, h - 1) < y1
            assert x0 <= np.clip(tx0 + o, 0, w - 1) < x1
            assert x0 <= np.clip(tx1 - 1 + o, 0, w - 1) < x1


def tree_sum(v: np.ndarray) -> np.ndarray:
    """block_sum of csrc/post_kernel.cu over the last axis (a power of
    two): v[t] = v[t] + v[t + k] for k = n/2, ..., 1, in float32."""
    v = v.copy()
    k = v.shape[-1] // 2
    while k > 0:
        v[..., :k] = v[..., :k] + v[..., k:2 * k]
        k //= 2
    return v[..., 0]


def kernel_partial(denoised, sky, sample_step, y_base=0, own=None):
    """The kernel's (log-luma sum, count) over an (h, w) launch: per tile,
    thread t = ly * TILE_W + lx holds log(1e-6 + luma) of its pixel where
    that is an owned pixel (rows ``own``, all by default) on the sample
    grid of global rows (row y is global row y_base + y), not sky, with
    luma > 0 (else 0), tree-summed; the total: thread t sums tiles t,
    t + 256, ... in order, then a tree."""
    h, w = sky.shape
    o0, o1 = (0, h) if own is None else own
    ny, nx = post_kernel.tiles(h, w)
    th, tw = post_kernel.TILE_H, post_kernel.TILE_W
    threads = th * tw
    ys, xs = np.mgrid[0:ny * th, 0:nx * tw]
    inside = (ys >= o0) & (ys < o1) & (xs < w)
    yc, xc = np.minimum(ys, h - 1), np.minimum(xs, w - 1)
    lum = luma(denoised).numpy().astype(np.float32)[yc, xc]
    use = (inside & ((ys + y_base) % sample_step == 0)
           & (xs % sample_step == 0) & ~sky.numpy()[yc, xc] & (lum > 0))
    val = np.where(use, np.log(np.float32(1e-6) + lum), np.float32(0))
    tile = lambda a: a.reshape(ny, th, nx, tw).transpose(0, 2, 1, 3) \
        .reshape(ny * nx, threads)
    part_v = tree_sum(tile(val.astype(np.float32)))
    part_c = tile(use.astype(np.int64)).sum(1)
    rows = -(-len(part_v) // threads)
    pad = np.zeros(rows * threads, np.float32)
    pad[:len(part_v)] = part_v
    acc = np.zeros(threads, np.float32)
    for r in range(rows):          # thread t: tiles t, t + 256, ...
        acc = acc + pad[r * threads:(r + 1) * threads]
    return tree_sum(acc), int(part_c.sum())


def kernel_exposure(denoised, sky, ae, cfg, sample_step):
    """The kernel's exposure: the whole launch's ``kernel_partial``, then
    the EMA of tonemap."""
    total, cnt = kernel_partial(denoised, sky, sample_step)
    ae = np.float32(ae)
    if not cfg.auto_exposure:
        return ae
    avg = np.exp(np.float32(total) / np.float32(max(cnt, 1)))
    target = np.float32(min(max(cfg.ae_key / max(avg, np.float32(1e-6)),
                                cfg.ae_min), cfg.ae_max))
    if cnt == 0:
        target = ae
    return np.float32(ae + (target - ae) * np.float32(tonemap.ae_rate(cfg)))


@pytest.mark.parametrize("w,h,step", [(48, 40, 2), (37, 23, 2), (40, 36, 4)])
def test_fixed_order_exposure_matches_update_exposure(w, h, step):
    """Traced Cornell planes through the plain post stages; the kernel's
    tile-order exposure against ``update_exposure``'s."""
    cfg = DEFAULT_CONFIG
    packed = trace_kernel.pack_scene(SCENE_BUILDERS["cornell"]())
    planes = [trace_kernel.trace_planes_plain(
        packed.scene, ray_params(packed.scene.default_pose, w, h, f), f, w, h,
        cfg) for f in (3, 2)]
    hist = planes[0][0:3] * 1.1
    flags = torch.tensor(True), torch.tensor(False)
    ae = torch.tensor(0.8)
    _, denoised, _, want = post_kernel.post_plain(
        planes[0], planes[1], hist, *flags, ae, cfg, step, False)
    sky = planes[0][3] > 0.5
    got = kernel_exposure(denoised.permute(1, 2, 0), sky, 0.8, cfg, step)
    assert abs(float(got) - float(want)) <= 1e-5
    ref, _ = tonemap.update_exposure(denoised.permute(1, 2, 0), sky, ae,
                                     cfg, step)
    assert float(ref) == float(want)
    off = dataclasses.replace(cfg, auto_exposure=False)
    assert kernel_exposure(denoised.permute(1, 2, 0), sky, 0.8, off,
                           step) == np.float32(0.8)


@pytest.mark.parametrize("world,step", [(4, 2), (3, 4), (6, 2)])
def test_band_partials_match_exposure_partials(world, step):
    """Launch A's partial over each extended band (its owned rows sampled
    on global rows) against ``tonemap.exposure_partials`` of the owned
    rows: equal counts, sums within 1e-4; summed over the bands, the
    whole launch's partial."""
    cfg = DEFAULT_CONFIG
    w, h = 40, 36
    packed = trace_kernel.pack_scene(SCENE_BUILDERS["cornell"]())
    planes = [trace_kernel.trace_planes_plain(
        packed.scene, ray_params(packed.scene.default_pose, w, h, f), f, w, h,
        cfg) for f in (3, 2)]
    _, denoised, _, _ = post_kernel.post_plain(
        planes[0], planes[1], planes[0][0:3] * 1.1, torch.tensor(True),
        torch.tensor(False), torch.tensor(0.8), cfg, step, False)
    img = denoised.permute(1, 2, 0)
    sky = planes[0][3] > 0.5
    halo = post_kernel.halo_rows(cfg)
    band = h // world
    total_v, total_c = np.float32(0), 0
    for r in range(world):
        y0, y1 = r * band, (r + 1) * band
        e0, e1 = max(0, y0 - halo), min(h, y1 + halo)
        v, c = kernel_partial(img[e0:e1], sky[e0:e1], step, e0,
                              (y0 - e0, y1 - e0))
        want_v, want_c = tonemap.exposure_partials(img[y0:y1], sky[y0:y1],
                                                   step, y0)
        assert c == int(want_c)
        assert abs(float(v) - float(want_v)) <= 1e-4
        total_v, total_c = total_v + v, total_c + c
    full_v, full_c = kernel_partial(img, sky, step)
    assert total_c == full_c
    assert abs(float(total_v) - float(full_v)) <= 1e-4
