"""The frame engine: frame state, frame step, frame scan, renderer.

Port of ``yetanotherconsolegameengine_tpu/render/renderer.py``: primitive
tables, meshes, voxels and textures, video textures and scenes that
change per frame included. A frame traces at ``hi_w = fb_w * ss`` by
``hi_h = fb_h * 2 * ss`` pixels (two pixels per '▀' character cell) and
returns per-cell colors and ANSI-256 indices.

``set_scene`` routes by ``trace_kernel.scene_fits``, before any launch, as
the JAX renderer does. On a CUDA device a scene that fits is two kernel
launches a frame: the trace kernel writes the (12, H, W) G-buffer and the
post kernel turns it into blended history, tone-mapped colors and ANSI
indices (ops/trace_kernel.py, post_kernel.py). Every other scene (meshes,
textures, tables too large for the kernel) traces through the PyTorch
wavefront (``trace_wavefront_planes``: ops/trace.py, whose cluster sweeps
launch the cluster kernel K3 and whose BVH sweeps walk in torch) and
posts through the same post kernel every frame. On the CPU the same
stages run as plain PyTorch. A scene with video textures resets TAA
history every frame, and its reader slots are refreshed once per
``render_many`` batch. ``impl`` selects
explicitly: "kernel" (the default on CUDA; refused on the CPU) or "plain"
(the default on the CPU). The renderer and ``init_state`` run on the card
unless ``device="cpu"`` is given (``devices.py``). Nothing falls back from
one to the other.

``frame_scan`` renders N frames in a Python loop: the camera rows, frame
indices and TAA resets of all N frames are computed on the device first,
and each frame's kernels read their row, so the loop issues launches
without waiting on the device.

Dynamic scenes: ``set_scene(..., static=False)`` sends a scene to the
wavefront whatever ``scene_fits`` says (``pack_scene`` builds the trace
kernel's table through the host; the JAX renderer likewise bypasses its
megakernel). Assigning ``renderer.scene`` swaps the scene the next frames
render and keeps the frame state, as the app shell does every tick of a
streamed or animated scene. ``render_many(times=, scene_fn=)`` renders
frame k of the batch from ``scene_fn(times[k])`` (e.g.
``DynamicScene.at_time``), with the times passed as Python floats, so a
batch patches the same rows as the same frames rendered one by one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from ..core import sampler
from ..core.camera import (CameraPose, make_jittered_rays, pixel_grid,
                           ray_params)
from ..devices import resolve_device, resolve_impl
from ..ops import ansi, post_kernel, taa, tonemap, trace, trace_kernel
from ..scene.tables import SceneData
from ..utils import profiling

BLOCK = 16   # primary lanes of cluster scenes in BLOCK x BLOCK pixel blocks


@dataclasses.dataclass(frozen=True)
class FrameState:
    """State threaded through frames; tensors live on the render device."""

    # A band of a sharded frame holds the owned rows of the history and
    # the extended band's rows of the G-buffer (init_state(shard=)).
    history: torch.Tensor        # (3, hiH, hiW) blended radiance
    prev_gbuf: torch.Tensor      # (12, hiH, hiW) last frame's G-buffer
    history_valid: torch.Tensor  # () bool
    ae_exposure: torch.Tensor    # () f32
    last_cam: torch.Tensor       # (3,)
    last_yaw: torch.Tensor       # ()
    last_pitch: torch.Tensor     # ()
    have_last: torch.Tensor      # () bool
    frame_idx: int               # frames rendered so far (host counter)


@dataclasses.dataclass(frozen=True)
class FrameOutput:
    """Per-cell results, (fb_h, fb_w[, 3])."""

    top_rgb: torch.Tensor      # tone-mapped [0,1] — the '▀' foreground
    bot_rgb: torch.Tensor      # background color
    fg_ansi: torch.Tensor      # int32 ANSI-256 index
    bg_ansi: torch.Tensor
    rays_traced: torch.Tensor  # () int64


def init_state(fb_w: int, fb_h: int, ss: int = 1, device="cuda",
               shard=None) -> FrameState:
    """A fresh frame state; with ``shard`` (a ``parallel.sharding.RowShard``)
    the state of its band: the history of the owned rows and the G-buffer
    of the extended band (``shard.ext``)."""
    device = resolve_device(device)
    hi_w, hi_h = fb_w * ss, fb_h * 2 * ss
    own_h = ext_h = hi_h
    if shard is not None:
        own_h, ext_h = shard.y1 - shard.y0, shard.ext[1] - shard.ext[0]
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    false = torch.zeros((), dtype=torch.bool, device=device)
    return FrameState(
        history=z(3, own_h, hi_w), prev_gbuf=z(12, ext_h, hi_w),
        history_valid=false, ae_exposure=z() + 1.0,
        last_cam=z(3), last_yaw=z(), last_pitch=z(), have_last=false,
        frame_idx=0)


def stack_poses(poses, fov_deg: float, device) -> CameraPose:
    """[(pos, yaw, pitch), ...] -> a CameraPose with a leading (N,) axis,
    uploaded in one copy per field (on a card each a blocking copy, the
    tracer's ``renderer.pose_upload``)."""
    def f(a):
        host = torch.from_numpy(np.asarray(a, np.float32))
        return profiling.sync("renderer.pose_upload", host.to, device)
    return CameraPose(pos=f([p for (p, _, _) in poses]),
                      yaw=f([y for (_, y, _) in poses]),
                      pitch=f([pt for (_, _, pt) in poses]),
                      fov_deg=f([fov_deg] * len(poses)))


def frame_inputs(cams: CameraPose, state: FrameState, hi_w: int, hi_h: int,
                 cfg: RenderConfig):
    """Per-frame kernel inputs of N frames, computed at once on the device:
    (ray_params (N, 18) f32, frame indices (N,) i32, TAA resets (N,) bool)."""
    n = cams.pos.shape[0]
    dev = cams.pos.device
    first = state.frame_idx + 1
    frames = ((first + torch.arange(n, dtype=torch.int64, device=dev))
              & 0x7FFFFFFF).to(torch.int32)
    params = ray_params(cams, hi_w, hi_h, frames).contiguous()
    prev_pos = torch.cat([state.last_cam[None], cams.pos[:-1]])
    prev_yaw = torch.cat([state.last_yaw[None], cams.yaw[:-1]])
    prev_pitch = torch.cat([state.last_pitch[None], cams.pitch[:-1]])
    have = torch.cat([state.have_last[None],
                      torch.ones(n - 1, dtype=torch.bool, device=dev)])
    resets = taa.should_reset_history(cams.pos, cams.yaw, cams.pitch,
                                      prev_pos, prev_yaw, prev_pitch, have,
                                      cfg)
    return params, frames, resets


def trace_wavefront_planes(scene: SceneData, params_row: torch.Tensor, frame,
                           width: int, height: int, cfg: RenderConfig,
                           impl: Optional[str] = None,
                           rows=None) -> torch.Tensor:
    """The (12, H, W) G-buffer of a scene traced by the wavefront:
    jittered rays and per-pixel seeds, then ``trace.trace_all``. For a
    cluster-mesh scene with ``cfg.block_order_primary`` and
    ``width % 16 == 0`` the lanes run in 16x16 pixel-block order (each
    256-lane tile of the primary sweep is one square block, swept
    unsorted), rows padded to a multiple of 16 with dead lanes that the
    G-buffer, and so ``rays_traced``, leaves out. ``rows`` = (y0, y1):
    trace only those rows of the ``height``-row frame, (12, y1 - y0, W);
    the blocks stay on the frame's 16-row grid, the band padded with dead
    rows above and below to whole blocks. A band whose edges fall inside
    a block sweeps those tiles with fewer live rays than the whole frame,
    which can change their cluster lists' order and so which of two
    triangles of equal quantized t wins (K3's tie rule).
    ``frame`` is an int or a 0-d integer tensor."""
    dev = params_row.device
    impl = resolve_impl(impl, dev)
    o, d = make_jittered_rays(None, width, height, frame, params=params_row,
                              rows=rows)
    px, py = pixel_grid(width, height, dev, rows)
    seed = sampler.per_frame_seed(px, py, frame, cfg.seed_salt)
    height = px.shape[0]
    if not (cfg.block_order_primary and scene.mesh_clusters is not None
            and width % BLOCK == 0):
        res = trace.trace_all(scene, o.reshape(-1, 3), d.reshape(-1, 3),
                              seed.reshape(-1), cfg, impl)
        return trace_kernel.result_planes(res, width, height)
    # Blocks on the whole frame's 16-row grid: a band starting inside a
    # block gets dead rows above its first, so each of its tiles is the
    # whole frame's tile less the rows of other bands.
    top = 0 if rows is None else rows[0] % BLOCK
    hp = (top + height + BLOCK - 1) // BLOCK * BLOCK

    def to_blocks(x, fill):
        if hp != height:
            pad = lambda n: torch.full((n,) + x.shape[1:], fill,
                                       dtype=x.dtype, device=dev)
            x = torch.cat([pad(top), x, pad(hp - top - height)])
        tail = x.shape[2:]
        x = x.reshape(hp // BLOCK, BLOCK, width // BLOCK, BLOCK, *tail)
        return x.transpose(1, 2).reshape(hp * width, *tail)

    def from_blocks(x):
        tail = x.shape[1:]
        x = x.reshape(hp // BLOCK, width // BLOCK, BLOCK, BLOCK, *tail)
        return x.transpose(1, 2).reshape(hp, width, *tail)[
            top:top + height].reshape(height * width, *tail)

    res = trace.trace_all(
        scene, to_blocks(o, 2.9e30), to_blocks(d, 1.0), to_blocks(seed, 0),
        dataclasses.replace(cfg, presort_primary=False), impl)
    cols = from_blocks(trace_kernel.lane_columns(res))
    return cols.T.reshape(12, height, width).contiguous()


def frame_step(packed, cams: CameraPose, inputs, row: int,
               state: FrameState, fb_w: int, fb_h: int, ss: int = 1,
               cfg: RenderConfig = DEFAULT_CONFIG,
               impl: Optional[str] = None, shard=None, group=None):
    """Render frame ``row`` of a batch whose ``frame_inputs`` are
    ``inputs``. ``packed``: a ``trace_kernel.PackedScene`` of a scene the
    trace kernel takes, or the ``SceneData`` of any other. ``impl`` (None:
    from the device) picks kernels or plain versions. Returns
    (FrameOutput, new FrameState).

    ``shard`` + ``group`` (``parallel.sharding``): render this rank's
    band of a frame sharded by rows. The band traces its owned rows,
    ``group.extend`` brings the extended band's G-buffer and history from
    the other ranks, the post runs as launch A over the extended band,
    ``group.combine`` sums the ranks' exposure partials and ray counts,
    and launch B posts the owned rows. ``state`` is the band's
    (``init_state(shard=)``); the output holds the band's cell rows and
    the whole frame's ``rays_traced``."""
    impl = resolve_impl(impl, cams.pos.device)
    hi_w, hi_h = fb_w * ss, fb_h * 2 * ss
    params, frames, resets = inputs
    rows = None if shard is None else (shard.y0, shard.y1)
    with profiling.span("frame.trace"):
        if isinstance(packed, SceneData):
            gbuf = trace_wavefront_planes(packed, params[row], frames[row],
                                          hi_w, hi_h, cfg, impl, rows)
        elif impl == "kernel":
            gbuf = trace_kernel.trace_planes(packed, params, frames, row,
                                             hi_w, hi_h, cfg, rows)
        else:
            gbuf = trace_kernel.trace_planes_plain(
                packed.scene, params[row],
                profiling.sync("renderer.frame_index", int, frames[row]),
                hi_w, hi_h, cfg, rows)
    with profiling.span("frame.post"):
        kernel = impl == "kernel"
        fuse_tail = ss == 1
        step = max(2, ss * 2)
        rays = gbuf[11].to(torch.int64).sum()
        if shard is None:
            post = post_kernel.post if kernel else post_kernel.post_plain
            blended, img, idx, new_ae = post(
                gbuf, state.prev_gbuf, state.history, state.history_valid,
                resets[row], state.ae_exposure, cfg, step, fuse_tail)
        else:
            band = (post_kernel.post_band if kernel
                    else post_kernel.post_band_plain)
            tail = (post_kernel.post_band_tail if kernel
                    else post_kernel.post_band_tail_plain)
            gbuf, history = group.extend(shard, gbuf, state.history)
            blended, denoised, part = band(
                gbuf, state.prev_gbuf, history, state.history_valid,
                resets[row], cfg, step, shard.ext[0], shard.own)
            total, rays = group.combine(part, rays)
            img, idx, new_ae = tail(denoised, total, state.ae_exposure, cfg,
                                    fuse_tail)
        if fuse_tail:
            # Even/odd rows are the top/bottom halves of each cell.
            mapped = img.permute(1, 2, 0)
            top, bot = mapped[0::2], mapped[1::2]
            fg, bg = idx[0::2], idx[1::2]
        else:
            cells = img.permute(1, 2, 0).reshape(-1, 2, ss, fb_w, ss, 3) \
                .mean(dim=(2, 4))
            exposure = cfg.tone_exposure * new_ae
            top = tonemap.map_pixels(cells[:, 0], exposure, cfg)
            bot = tonemap.map_pixels(cells[:, 1], exposure, cfg)
            fg, bg = ansi.rgb_to_ansi256(top), ansi.rgb_to_ansi256(bot)
        out = FrameOutput(top_rgb=top, bot_rgb=bot, fg_ansi=fg, bg_ansi=bg,
                          rays_traced=rays)
        new_state = FrameState(
            history=blended, prev_gbuf=gbuf,
            history_valid=torch.ones((), dtype=torch.bool,
                                     device=gbuf.device),
            ae_exposure=new_ae, last_cam=cams.pos[row],
            last_yaw=cams.yaw[row], last_pitch=cams.pitch[row],
            have_last=state.history_valid.new_ones(()),
            frame_idx=state.frame_idx + 1)
        return out, new_state


def _rgb_u8(x: torch.Tensor) -> torch.Tensor:
    """Display [0,1] RGB -> u8, round to nearest."""
    return (torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def frame_scan(packed, cams: CameraPose, state: FrameState, fb_w: int,
               fb_h: int, ss: int = 1, cfg: RenderConfig = DEFAULT_CONFIG,
               impl: Optional[str] = None, stack_rgb: bool = False,
               scene_fn=None, ts=None):
    """Render N frames (``cams`` has a leading (N,) axis). Returns
    ((fg_u8, bg_u8[, top_u8, bot_u8]) stacked (N, fb_h, fb_w[, 3]), the
    last FrameOutput, the final state).

    ``scene_fn`` + ``ts``: frame k renders the SceneData ``scene_fn(ts[k])``
    (``ts``: N Python floats) through the wavefront, moved to the frame's
    device if it is elsewhere; ``packed`` is then the scene's base and
    must not be the trace kernel's packed tables, which cannot follow a
    changing scene."""
    n = cams.pos.shape[0]
    dev = cams.pos.device
    impl = resolve_impl(impl, dev)
    if scene_fn is not None:
        if not isinstance(packed, SceneData):
            raise ValueError("scene_fn needs a wavefront scene: set it with "
                             "set_scene(..., static=False)")
        if len(ts) != n:
            raise ValueError(f"{len(ts)} times for {n} frames")
    with profiling.span("render.prep"):
        inputs = frame_inputs(cams, state, fb_w * ss, fb_h * 2 * ss, cfg)
        if isinstance(packed, SceneData) and packed.has_dynamic_textures:
            # A live texture changes every frame: no history to blend.
            inputs = inputs[:2] + (torch.ones_like(inputs[2]),)
        shapes = [(n, fb_h, fb_w)] * 2 + ([(n, fb_h, fb_w, 3)] * 2
                                           if stack_rgb else [])
        grids = tuple(torch.empty(s, dtype=torch.uint8, device=dev)
                      for s in shapes)
    out = None
    for row in range(n):
        scene = packed
        if scene_fn is not None:
            scene = scene_fn(ts[row])
            if scene.device != dev:
                scene = scene.to(dev)
        out, state = frame_step(scene, cams, inputs, row, state, fb_w, fb_h,
                                ss, cfg, impl)
        with profiling.span("frame.post"):
            grids[0][row] = out.fg_ansi
            grids[1][row] = out.bg_ansi
            if stack_rgb:
                grids[2][row] = _rgb_u8(out.top_rgb)
                grids[3][row] = _rgb_u8(out.bot_rgb)
    return grids, out, state


class RaytraceRenderer:
    """Owns the scene on its device, the frame state and the camera.

    ``device``: where the frame runs, the card unless ``"cpu"`` is given
    (raises when there is no card). ``impl``: "kernel" (CUDA kernels; the
    default on a CUDA device, refused elsewhere) or "plain" (PyTorch ops;
    the default on the CPU).
    """

    def __init__(self, scene: SceneData, fb_w: int, fb_h: int, ss: int = 1,
                 cfg: RenderConfig = DEFAULT_CONFIG,
                 fov_deg: Optional[float] = None, device="cuda",
                 impl: Optional[str] = None):
        self.device = resolve_device(device)
        self.impl = resolve_impl(impl, self.device)
        self.cfg = cfg
        self.fb_w, self.fb_h, self.ss = fb_w, fb_h, max(1, ss)
        self.set_scene(scene)
        if fov_deg is not None:
            self.fov_deg = float(fov_deg)

    def set_scene(self, scene: SceneData, reset_camera: bool = True,
                  static: bool = True):
        """Move ``scene`` to the render device (an LBVH is rebuilt there),
        route it and start a fresh frame state. ``static=False`` marks
        geometry that changes per frame: the scene, and every scene later
        assigned to ``self.scene``, goes to the wavefront. A static scene
        takes the trace kernel's packed tables when it fits
        (``trace_kernel.scene_fits``), else the wavefront."""
        self.static = static
        scene = scene.to(self.device)
        if scene.has_dynamic_textures:
            # The reader slots are written in place: own the bank.
            scene = dataclasses.replace(scene,
                                        textures=scene.textures.clone())
        self.scene = scene
        self.state = init_state(self.fb_w, self.fb_h, self.ss, self.device)
        if reset_camera:
            d = scene.defaults
            self.cam_pos, self.yaw, self.pitch = list(d[0:3]), d[3], d[4]
            self.fov_deg = d[5]

    @property
    def scene(self) -> SceneData:
        return self._scene

    @scene.setter
    def scene(self, scene: SceneData):
        """Swap the scene the next frames render, keeping the frame state:
        moved to the render device and routed under the current
        ``static`` flag."""
        scene = scene.to(self.device)
        self._scene = scene
        self.packed = (trace_kernel.pack_scene(scene)
                       if self.static
                       and trace_kernel.scene_fits(scene, self.cfg)
                       else scene)

    def set_camera(self, pos, yaw, pitch):
        self.cam_pos = list(pos)
        self.yaw, self.pitch = float(yaw), float(pitch)

    def set_fov(self, fov_deg: float):
        """The vertical field of view, in degrees, of the next frames."""
        self.fov_deg = float(fov_deg)

    def resize(self, fb_w: int, fb_h: int, ss: Optional[int] = None):
        if ss is not None:
            self.ss = max(1, ss)
        self.fb_w, self.fb_h = fb_w, fb_h
        self.state = init_state(fb_w, fb_h, self.ss, self.device)

    def _update_video_textures(self) -> None:
        """Write each live reader's newest frame into its slot of the
        scene's texture bank."""
        if not self.scene.has_dynamic_textures:
            return
        from ..video import textures as vidtex
        for tid, reader in vidtex.readers_for(self.scene.name):
            frame = reader.try_get_frame()
            if frame is None:
                continue
            img = torch.from_numpy(vidtex.frame_to_texture(frame))
            h, w = img.shape[:2]
            self.scene.textures[tid, :h, :w].copy_(img)

    def render(self) -> FrameOutput:
        _, out = self.render_many(1)
        return out

    def render_many(self, n: int, poses=None, rgb: bool = False,
                    times=None, scene_fn=None):
        """Render ``n`` frames; ``poses``: optional [(pos, yaw, pitch)] per
        frame. Returns ((fg_u8, bg_u8[, top_u8, bot_u8]) stacked
        (n, fb_h, fb_w[, 3]), the last frame's FrameOutput).
        ``times`` + ``scene_fn`` render a scene that changes per frame:
        frame k is ``scene_fn(times[k])`` (e.g. ``DynamicScene.at_time``;
        the renderer's scene must be set with ``static=False``)."""
        with profiling.span("render.call"):
            with profiling.span("render.prep"):
                self._update_video_textures()
                if poses is None:
                    poses = [(self.cam_pos, self.yaw, self.pitch)] * n
                cams = stack_poses(poses, self.fov_deg, self.device)
                ts = None if times is None else [float(t) for t in times]
            grids, out, self.state = frame_scan(
                self.packed, cams, self.state, self.fb_w, self.fb_h, self.ss,
                self.cfg, self.impl, stack_rgb=rgb, scene_fn=scene_fn, ts=ts)
        return grids, out
