"""The post kernel's wrapper and its plain version.

Port of ``yetanotherconsolegameengine_tpu/ops/pallas_post.py``
(``build_post_kernel`` / ``post_fused_tail`` / ``post_fused``): TAA, the
à-trous passes, auto-exposure and, with ``fuse_tail`` (ss == 1), the
tone map and ANSI-256 quantization at full resolution. The CUDA source is
``csrc/post_kernel.cu``; the plain version chains ``ops/taa.py``,
``atrous.py``, ``tonemap.py`` and ``ansi.py``.

Both take the current and previous frames' (12, H, W) G-buffers as the
trace kernel writes them (ops/trace_kernel.py PLANES), so the frame state
keeps the previous G-buffer as it is. A depth of INF (no primary hit)
reads as 3.4e38, the guide depth of the JAX frame step.

Row bands (parallel/sharding.py) run K1 as two launches: ``post_band``
(launch A) over a band plus ``halo_rows(cfg)`` rows each side, returning
the owned rows' blended and denoised colour and their exposure partial;
the ranks combine the partials; ``post_band_tail`` (launch B) computes
the exposure from the combined partial and runs the tail on the owned
rows. ``post_band_plain`` and ``post_band_tail_plain`` are their plain
versions.
"""

from __future__ import annotations

import functools

import torch

from ..config import RenderConfig
from . import ansi, atrous, kernels, taa, tonemap
from .intersect import INF

FAR_DEPTH = 3.4e38
# Output tiles of csrc/post_kernel.cu (TILE_H, TILE_W), one thread a pixel.
TILE_H = TILE_W = 16


def guide_depth(depth: torch.Tensor) -> torch.Tensor:
    return torch.where(depth >= INF, FAR_DEPTH, depth)


def _hwc(planes: torch.Tensor) -> torch.Tensor:
    return planes.permute(1, 2, 0)


def _chw(img: torch.Tensor) -> torch.Tensor:
    return img.permute(2, 0, 1).contiguous()


def halo_rows(cfg: RenderConfig) -> int:
    """Rows K1's stencils reach: the TAA clamp radius plus 2 * dilation
    for each 5x5 a-trous pass (dilations 1, 2, 4, ...). A band posted
    with this many rows of its neighbours each side gets the whole
    frame's owned rows."""
    return (max(0, cfg.taa_clamp_radius)
            + 2 * sum(1 << i for i in range(max(1, cfg.atrous_iterations))))


def _stages(gbuf, prev_gbuf, history, history_valid, force_reset,
            cfg: RenderConfig):
    """TAA and the a-trous passes: (blended, denoised) (H, W, 3), sky."""
    sky = gbuf[3] > 0.5
    depth = guide_depth(gbuf[10])
    normal = _hwc(gbuf[7:10])
    blended = taa.temporal_blend(
        _hwc(gbuf[0:3]), normal, depth, sky, _hwc(history),
        _hwc(prev_gbuf[7:10]), guide_depth(prev_gbuf[10]),
        prev_gbuf[3] > 0.5, history_valid, force_reset, cfg)
    denoised = atrous.atrous_denoise(blended, _hwc(gbuf[4:7]), normal,
                                     depth, sky, cfg)
    return blended, denoised, sky


def post_plain(gbuf, prev_gbuf, history, history_valid, force_reset,
               ae_exposure, cfg: RenderConfig, sample_step: int,
               fuse_tail: bool):
    """Returns (blended (3, H, W), mapped if fuse_tail else denoised
    (3, H, W), ANSI indices (H, W) i32 or None, new exposure 0-d)."""
    blended, denoised, sky = _stages(gbuf, prev_gbuf, history,
                                     history_valid, force_reset, cfg)
    new_ae, exposure = tonemap.update_exposure(denoised, sky, ae_exposure,
                                               cfg, sample_step)
    if not fuse_tail:
        return _chw(blended), _chw(denoised), None, new_ae
    mapped = tonemap.map_pixels(denoised, exposure, cfg)
    return (_chw(blended), _chw(mapped), ansi.rgb_to_ansi256(mapped),
            new_ae)


def post_band_plain(gbuf, prev_gbuf, history, history_valid, force_reset,
                    cfg: RenderConfig, sample_step: int, y_first: int,
                    own: tuple):
    """Launch A's plain version: the plain stages on an extended band
    (the (12, E, W) G-buffers and (3, E, W) history of rows
    [y_first, y_first + E) of the frame), then its owned rows
    ``own`` = (o0, o1), local to the band. Returns (blended, denoised)
    (3, o1 - o0, W) and the owned rows' exposure partial, (2,) f32
    (log-luma sum, count) over the whole frame's sample grid."""
    blended, denoised, sky = _stages(gbuf, prev_gbuf, history,
                                     history_valid, force_reset, cfg)
    o0, o1 = own
    log_sum, count = tonemap.exposure_partials(
        denoised[o0:o1], sky[o0:o1], sample_step, y_first + o0)
    return (_chw(blended[o0:o1]), _chw(denoised[o0:o1]),
            torch.stack([log_sum, count.to(torch.float32)]))


def post_band_tail_plain(denoised, total, ae_exposure, cfg: RenderConfig,
                         fuse_tail: bool):
    """Launch B's plain version: the exposure from the combined partial
    ``total`` (2,) f32, then with ``fuse_tail`` the tone map and ANSI-256
    of the owned rows. Returns (mapped if fuse_tail else denoised,
    ANSI indices or None, new exposure 0-d)."""
    new_ae, exposure = tonemap.exposure_from_partials(total[0], total[1],
                                                      ae_exposure, cfg)
    if not fuse_tail:
        return denoised, None, new_ae
    mapped = tonemap.map_pixels(_hwc(denoised), exposure, cfg)
    return _chw(mapped), ansi.rgb_to_ansi256(mapped), new_ae


def combine_partials(parts: torch.Tensor) -> torch.Tensor:
    """(N, 2) partials of N bands -> their (2,) total, summed in band
    order: every rank that holds the same partials gets the same bits."""
    total = parts[0]
    for k in range(1, parts.shape[0]):
        total = total + parts[k]
    return total


def tiles(h: int, w: int) -> tuple:
    """(rows, columns) of the kernel's output tiles over an (h, w) frame;
    tile k is row k // columns, column k % columns."""
    return -(-h // TILE_H), -(-w // TILE_W)


def tile_window(k: int, h: int, w: int, halo: int) -> tuple:
    """Pixels (y0, y1, x0, x1) that tile ``k`` stages for a stencil of
    reach ``halo``: the tile +- halo, cut to the image."""
    _, nx = tiles(h, w)
    ty, tx = divmod(k, nx)
    return (max(ty * TILE_H - halo, 0), min((ty + 1) * TILE_H + halo, h),
            max(tx * TILE_W - halo, 0), min((tx + 1) * TILE_W + halo, w))


def scratch_floats(h: int, w: int) -> int:
    """The kernel's scratch: two (rgb, luma) colour planes and the two
    guide float4 planes per pixel, then two exposure partials per tile."""
    ny, nx = tiles(h, w)
    return 16 * h * w + 2 * ny * nx


@functools.lru_cache(maxsize=8)
def _scratch(device: torch.device, stream: int, h: int, w: int):
    """The kernel's scratch for an (h, w) frame on one stream, kept across
    calls: a launch writes and reads it and leaves nothing in it, and the
    launches on one stream run in order. 16-byte aligned for its float4s."""
    return torch.empty(scratch_floats(h, w), dtype=torch.float32,
                       device=device)


def post(gbuf, prev_gbuf, history, history_valid, force_reset, ae_exposure,
         cfg: RenderConfig, sample_step: int, fuse_tail: bool):
    """Run the post kernel on CUDA tensors (the plain version for CPU
    tensors). ``history_valid`` / ``force_reset`` are 0-d bool tensors and
    ``ae_exposure`` a 0-d f32 tensor; all stay on the device. Returns what
    ``post_plain`` returns. Raises if its grid cannot be co-resident."""
    if gbuf.device.type == "cpu":
        return post_plain(gbuf, prev_gbuf, history, history_valid,
                          force_reset, ae_exposure, cfg, sample_step,
                          fuse_tail)
    _, h, w = gbuf.shape
    kernels.require(gbuf, "gbuf", torch.float32, (12, h, w))
    kernels.require(prev_gbuf, "prev_gbuf", torch.float32, (12, h, w))
    kernels.require(history, "history", torch.float32, (3, h, w))
    kernels.require(history_valid, "history_valid", torch.bool, ())
    kernels.require(force_reset, "force_reset", torch.bool, ())
    kernels.require(ae_exposure, "ae_exposure", torch.float32, ())
    dev = gbuf.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _scratch(dev, stream, h, w)
    # One allocation (each costs the host several microseconds) for the six
    # output planes and the new exposure.
    buf = torch.empty(6 * h * w + 1, dtype=torch.float32, device=dev)
    out = buf[:-1].view(6, h, w)
    new_ae = buf[-1]
    idx = (torch.empty((h, w), dtype=torch.int32, device=dev)
           if fuse_tail else None)
    lib = kernels.library()
    err = lib.yacge_post_launch(
        gbuf.data_ptr(), prev_gbuf.data_ptr(), history.data_ptr(),
        force_reset.data_ptr(), history_valid.data_ptr(),
        ae_exposure.data_ptr(), out.data_ptr(),
        None if idx is None else idx.data_ptr(), new_ae.data_ptr(),
        scratch.data_ptr(), None, w, h, 0, 0, h,
        max(1, cfg.atrous_iterations), int(fuse_tail),
        *_scalars(cfg, max(2, sample_step)), stream)
    kernels.check(err, "post kernel")
    kernels.LAUNCHES["post"] += 1
    return out[0:3], out[3:6], idx, new_ae


def post_band(gbuf, prev_gbuf, history, history_valid, force_reset,
              cfg: RenderConfig, sample_step: int, y_first: int, own: tuple):
    """Launch A of a band on CUDA tensors (``post_band_plain`` for CPU
    tensors): the post kernel over the extended band, writing the owned
    rows and their exposure partial. Returns what ``post_band_plain``
    returns."""
    if gbuf.device.type == "cpu":
        return post_band_plain(gbuf, prev_gbuf, history, history_valid,
                               force_reset, cfg, sample_step, y_first, own)
    _, h, w = gbuf.shape
    o0, o1 = own
    if not (0 <= o0 < o1 <= h and y_first >= 0):
        raise ValueError(f"owned rows {own} outside a band of {h} rows "
                         f"starting at row {y_first}")
    kernels.require(gbuf, "gbuf", torch.float32, (12, h, w))
    kernels.require(prev_gbuf, "prev_gbuf", torch.float32, (12, h, w))
    kernels.require(history, "history", torch.float32, (3, h, w))
    kernels.require(history_valid, "history_valid", torch.bool, ())
    kernels.require(force_reset, "force_reset", torch.bool, ())
    dev = gbuf.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _scratch(dev, stream, h, w)
    buf = torch.empty(6 * (o1 - o0) * w + 2, dtype=torch.float32, device=dev)
    out = buf[:-2].view(6, o1 - o0, w)
    part = buf[-2:]
    err = kernels.library().yacge_post_launch(
        gbuf.data_ptr(), prev_gbuf.data_ptr(), history.data_ptr(),
        force_reset.data_ptr(), history_valid.data_ptr(), None,
        out.data_ptr(), None, None, scratch.data_ptr(), part.data_ptr(), w,
        h, y_first, o0, o1, max(1, cfg.atrous_iterations), 0,
        *_scalars(cfg, max(2, sample_step)), stream)
    kernels.check(err, "post kernel (band launch A)")
    kernels.LAUNCHES["post"] += 1
    return out[0:3], out[3:6], part


def post_band_tail(denoised, total, ae_exposure, cfg: RenderConfig,
                   fuse_tail: bool):
    """Launch B of a band on CUDA tensors (``post_band_tail_plain`` for
    CPU tensors): ``denoised`` (3, R, W) the owned rows, ``total`` (2,)
    f32 the ranks' combined partial. Returns what the plain version
    returns."""
    if denoised.device.type == "cpu":
        return post_band_tail_plain(denoised, total, ae_exposure, cfg,
                                    fuse_tail)
    _, r, w = denoised.shape
    kernels.require(denoised, "denoised", torch.float32, (3, r, w))
    kernels.require(total, "total", torch.float32, (2,))
    kernels.require(ae_exposure, "ae_exposure", torch.float32, ())
    dev = denoised.device
    buf = torch.empty(3 * r * w * fuse_tail + 1, dtype=torch.float32,
                      device=dev)
    new_ae = buf[-1]
    mapped = buf[:-1].view(3, r, w) if fuse_tail else None
    idx = (torch.empty((r, w), dtype=torch.int32, device=dev)
           if fuse_tail else None)
    err = kernels.library().yacge_post_tail_launch(
        denoised.data_ptr(), None if mapped is None else mapped.data_ptr(),
        None if idx is None else idx.data_ptr(), total.data_ptr(),
        ae_exposure.data_ptr(), new_ae.data_ptr(), r * w, int(fuse_tail),
        *_scalars(cfg, 2), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "post kernel (band launch B)")
    kernels.LAUNCHES["post"] += 1
    return (denoised if mapped is None else mapped), idx, new_ae


@functools.lru_cache(maxsize=16)
def _scalars(cfg: RenderConfig, sample_step: int) -> tuple:
    """The launcher's arguments from ``alpha`` to ``vibrance``, clamped as
    the plain stages clamp them."""
    return (min(max(cfg.taa_alpha, 0.0), 1.0), cfg.taa_luminance_pad,
            max(0, cfg.taa_clamp_radius), 1.0 / max(1e-6, cfg.atrous_c_phi),
            1.0 / max(1e-6, cfg.atrous_n_phi),
            1.0 / max(1e-6, cfg.atrous_z_phi),
            1.0 / max(1e-6, cfg.atrous_a_phi), sample_step,
            int(cfg.auto_exposure), cfg.ae_key, cfg.ae_min, cfg.ae_max,
            tonemap.ae_rate(cfg), cfg.tone_exposure,
            1.0 / max(0.1, cfg.tone_gamma), cfg.tone_saturation,
            cfg.tone_vibrance)
