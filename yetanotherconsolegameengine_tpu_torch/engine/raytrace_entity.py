"""The renderer controller component.

Port of ``yetanotherconsolegameengine_tpu/engine/raytrace_entity.py``, the
counterpart of the C# RaytraceEntity (RaytraceEntity.cs:10-345): owns the
scene table (lazily built and cached), scene cycling on I/U with a 1 s
cooldown, camera control, live resize, and the per-frame update that
pushes the camera, renders, and blits the half-block cell grid into the
entity framebuffer with a HUD info string. The voxel world entry streams
through a VolumeScene with player physics instead of a static SceneData.

The component renders on ``device``, the card unless ``"cpu"`` is given.
Scenes are built on the host and moved to the device once, when first
entered. Streamed and animated scenes are set with ``static=False`` and
swapped every tick through the renderer's ``scene`` setter. Frames reach
the framebuffer as numpy planes: each frame's (or batch's) planes start
their copy to the host as soon as its launches are issued, and the tick
that blits them waits for that copy only, so with one frame in flight the
card renders frame N while the host blits frame N-1.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..devices import resolve_device
from ..render.renderer import RaytraceRenderer
from ..scene.builders import SCENE_BUILDERS
from ..utils import profiling
from .chexel import Framebuffer
from .entity import BaseComponent
from .fly_camera import FlyCamera

SCENE_SWITCH_COOLDOWN = 1.0  # RaytraceEntity.cs:183-213


def default_scene_order() -> List[str]:
    """The scene table (RaytraceEntity.BuildSceneTable,
    RaytraceEntity.cs:319-344)."""
    order = ["test", "cornell", "mirror_spheres", "primitives", "boxes",
             "demo_random", "texture_test", "glass", "museum",
             "exhibit_ring", "spinning_mesh", "bunny", "teapot", "cow",
             "dragon", "glass_gem", "all_meshes", "voxel_test",
             "voxel_cave", "video_texture", "minecraft_like"]
    return [n for n in order if n in SCENE_BUILDERS or n == "minecraft_like"]


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on its way to the host, ``to("cpu", non_blocking=True)``. A
    CUDA tensor whose dimensions do not run in row-major order (the RGB
    planes' channel-last views) gets a host tensor in its own order, and
    PyTorch stages that copy through pageable memory: it waits for the
    card, counted as the tracer's ``entity.host_copy``."""
    if not t.is_cuda:
        return t.to("cpu", non_blocking=True)
    t0 = time.perf_counter_ns()
    host = t.to("cpu", non_blocking=True)
    if not host.is_contiguous():
        profiling.waited("entity.host_copy", time.perf_counter_ns() - t0)
    return host


class HostCopy:
    """Tensors on their way to the host: the copies are queued behind the
    launches that produce them (into pinned memory, without waiting, but
    see ``_to_host``), and ``numpy()`` waits for them alone."""

    def __init__(self, tensors):
        self._host = [_to_host(t) for t in tensors]
        self._done = None
        if any(t.is_cuda for t in tensors):
            self._done = torch.cuda.Event()
            self._done.record()

    def numpy(self) -> List[np.ndarray]:
        if self._done is not None:
            profiling.sync("entity.copy_wait", self._done.synchronize)
        return [t.numpy() for t in self._host]


class RaytraceComponent(BaseComponent):
    def __init__(self, fb: Framebuffer, scene_names: Optional[List[str]] = None,
                 ss: int = 1, start_scene: Union[int, str] = 0,
                 enable_world: bool = True, batch: int = 1, device="cuda"):
        super().__init__()
        self.fb = fb
        self.ss = ss
        self.device = resolve_device(device)
        self.scene_names = scene_names or default_scene_order()
        if not enable_world and "minecraft_like" in self.scene_names:
            self.scene_names.remove("minecraft_like")
        if isinstance(start_scene, str):
            start_scene = self.scene_names.index(start_scene)
        self.scene_idx = start_scene
        self._cache: Dict[str, object] = {}  # name -> scene on the device
        self._last_switch = 0.0
        self.camera = FlyCamera()
        self.renderer: Optional[RaytraceRenderer] = None
        self.info = ""
        self.show_hud = True
        self._frame_times: List[float] = []
        self._volume = None  # active VolumeScene, if any
        self._dynamic = None  # active DynamicScene, if any
        self._video = None   # active VideoRenderer, if any
        self._pending: Optional[HostCopy] = None  # frame blitted next tick
        # Batched app loop: K frames per render_many, input replayed at
        # dispatch rate (see _update_batched).
        self.batch = max(1, int(batch))
        self._batch_cur = None   # host (fg, bg, top, bot) of K frames
        self._batch_pos = 0
        self._batch_inflight: Optional[HostCopy] = None
        self._batch_rays = 0
        self._switch_to(self.scene_idx, force=True)

    # -- scene table (GetOrBuildScene, RaytraceEntity.cs:303-315) ----------

    def _get_or_build(self, name: str):
        if name not in self._cache:
            if name == "minecraft_like":
                from ..world.volume_scene import build_minecraft_like
                self._cache[name] = build_minecraft_like(device=self.device)
            else:
                # SceneData and DynamicScene both move as one value.
                self._cache[name] = SCENE_BUILDERS[name]().to(self.device)
        return self._cache[name]

    def _release_scene_readers(self, name: str):
        """Close a dynamic-texture scene's video readers when leaving it,
        and evict the scene: its texture slots were bound to the closed
        readers, so a later re-entry rebuilds it with fresh readers."""
        obj = self._cache.get(name)
        if obj is not None and getattr(obj, "has_dynamic_textures", False):
            from ..video.textures import unregister_scene
            unregister_scene(name)
            del self._cache[name]

    def close(self):
        self._release_scene_readers(self.scene_names[self.scene_idx])
        if self._video is not None:
            self._video.reader.close()
            self._video = None

    def _reset_pipeline(self):
        self._pending = None
        self._batch_cur = None
        self._batch_pos = 0
        self._batch_inflight = None

    def _switch_to(self, idx: int, force: bool = False):
        now = time.monotonic()
        if not force and now - self._last_switch < SCENE_SWITCH_COOLDOWN:
            return
        self._last_switch = now
        self._reset_pipeline()
        if self.renderer is not None:   # not the constructor's first call
            self._release_scene_readers(self.scene_names[self.scene_idx])
        self.scene_idx = idx % len(self.scene_names)
        name = self.scene_names[self.scene_idx]
        obj = self._get_or_build(name)
        from ..scene.entities import DynamicScene
        from ..world.volume_scene import VolumeScene
        self._volume = None
        self._dynamic = None
        if isinstance(obj, VolumeScene):
            self._volume = obj
            scene = obj.update(0.0)
            self.camera.set_pose(tuple(obj.pos), obj.yaw, obj.pitch)
        elif isinstance(obj, DynamicScene):
            self._dynamic = obj
            scene = obj.at_time(obj.t)
            d = scene.defaults
            self.camera.set_pose(d[0:3], d[3], d[4])
        else:
            scene = obj
            d = scene.defaults
            self.camera.set_pose(d[0:3], d[3], d[4])
        static = self._volume is None and self._dynamic is None
        if self.renderer is None:
            self.renderer = RaytraceRenderer(
                scene, fb_w=self.fb.width, fb_h=self.fb.height, ss=self.ss,
                device=self.device)
            if not static:
                self.renderer.set_scene(scene, reset_camera=False,
                                        static=False)
        else:
            # The TAA/exposure state resets here (fresh history on switch).
            self.renderer.set_scene(scene, reset_camera=False, static=static)

    # -- input (RaytraceEntity.HandleInput, :168-213) ------------------------

    def handle_key(self, key: str) -> bool:
        k = key.lower()
        if k == "i":
            self._switch_to(self.scene_idx + 1)
            return True
        if k == "u":
            self._switch_to(self.scene_idx - 1)
            return True
        if k == "y":
            self.camera.toggle_orbit()
            return True
        if k == "h":
            self.show_hud = not self.show_hud
            return True
        if k == "f" and self._volume is not None:
            self._volume.flying = not self._volume.flying
            return True
        if k == "p":
            self.fb.to_png(os.path.join(
                tempfile.gettempdir(),
                f"yacge_{self.scene_names[self.scene_idx]}"
                f"_{int(time.time())}.png"))
            return True
        if k == "v":
            # Video mode toggle (RaytraceEntity.cs:248-282); synthetic
            # source by default, a real file via YACGE_VIDEO + ffmpeg.
            self._toggle_video()
            return True
        return False

    def _toggle_video(self):
        if self._video is not None:
            self._video.reader.close()
            self._video = None
            return
        from ..video.readers import FfmpegVideoReader, SyntheticReader
        from ..video.renderer import VideoRenderer
        path = os.environ.get("YACGE_VIDEO", "")
        try:
            reader = (FfmpegVideoReader(path) if path
                      else SyntheticReader())
        except RuntimeError:
            reader = SyntheticReader()
        self._video = VideoRenderer(reader, self.fb.width, self.fb.height,
                                    ss=self.ss, device=self.device)

    def handle_mouse(self, ev) -> bool:
        return self.camera.handle_mouse(ev)

    # -- resize (RaytraceEntity.Resize, :284-301) ---------------------------

    def resize(self, fb: Framebuffer):
        self.fb = fb
        self._reset_pipeline()
        if self.renderer is not None:
            self.renderer.resize(fb.width, fb.height, self.ss)

    # -- frame (RaytraceEntity.Update, :221-232) ----------------------------

    def update(self, dt: float):
        with profiling.span("component.update"):
            self._update(dt)

    def _update(self, dt: float):
        inp = getattr(self.entity, "input", None)
        if self._video is not None:
            out = self._video.render()
            if out is not None:
                self.fb.blit_half_blocks(*(x.cpu().numpy() for x in out))
            if self.show_hud:
                self.fb.write_text(0, 0, " video mode (V to exit) ")
            return
        if self.batch > 1:
            # Batched loop (static, volume or dynamic scene): input replays
            # at dispatch rate inside _update_batched; volume physics and
            # dynamic-scene time advance per replayed tick there.
            self._update_batched(dt, inp)
            return
        if self._volume is not None:
            vs = self._volume
            self._volume_input(vs, inp, dt)
            self.renderer.scene = vs.update(dt)
            self.camera.set_pose(tuple(vs.pos), vs.yaw, vs.pitch)
        elif self._dynamic is not None:
            self.renderer.scene = self._dynamic.update(dt)
            if inp is not None:
                self.camera.update(inp, dt)
        elif inp is not None:
            self.camera.update(inp, dt)

        r = self.renderer
        r.set_camera(self.camera.pos, self.camera.yaw, self.camera.pitch)
        t0 = time.perf_counter()
        # One frame in flight: issue frame N, then blit frame N-1, whose
        # copy to the host was queued behind its own launches last tick.
        out = r.render()
        blitted = self._pending
        rays = None
        if blitted is not None:
            top, bot, fg, bg, rays = blitted.numpy()
            with profiling.span("component.blit"):
                self.fb.blit_half_blocks(top, bot, fg, bg)
        self._pending = HostCopy((out.top_rgb, out.bot_rgb, out.fg_ansi,
                                  out.bg_ansi, out.rays_traced))
        frame_ms = (time.perf_counter() - t0) * 1000.0
        self._frame_times.append(frame_ms)
        if len(self._frame_times) > 30:
            self._frame_times.pop(0)

        if self.show_hud:
            # Ray stats of the frame blitted this tick; only the first
            # tick after a switch, with nothing blitted, reads the new
            # frame's.
            n_rays = (int(rays) if rays is not None else profiling.sync(
                "entity.first_rays", int, out.rays_traced))
            with profiling.span("component.blit"):
                self.info = self._info_string(n_rays, frame_ms)
                self.fb.write_text(0, 0, self.info[: self.fb.width])

    @staticmethod
    def _volume_input(vs, inp, dt: float):
        """One tick of player input -> VolumeScene physics intent."""
        if inp is None:
            return
        fwd = (1.0 if inp.is_key_down("w") else 0.0) - \
              (1.0 if inp.is_key_down("s") else 0.0)
        strafe = (1.0 if inp.is_key_down("d") else 0.0) - \
                 (1.0 if inp.is_key_down("a") else 0.0)
        up = (1.0 if inp.is_key_down("e") or inp.is_key_down(" ")
              else 0.0) - (1.0 if inp.is_key_down("q") else 0.0)
        jump = inp.is_key_down(" ")
        la = 1.6 * dt
        if inp.is_key_down("left"):
            vs.yaw -= la
        if inp.is_key_down("right"):
            vs.yaw += la
        if inp.is_key_down("up"):
            vs.pitch = min(1.45, vs.pitch + la)
        if inp.is_key_down("down"):
            vs.pitch = max(-1.45, vs.pitch - la)
        vs.apply_input(fwd, strafe, up, jump, inp.is_key_down("shift"), dt)

    def _dispatch_batch(self, dt: float, inp):
        """Integrate K ticks forward from the current input state (input
        replay at dispatch rate), render K frames with one render_many and
        queue their grids' copy to the host.

        Volume scenes run K host physics ticks and the whole batch renders
        against the batch-end scene tables, so a chunk that streams in
        mid-batch appears at most K-1 frames early. Dynamic scenes render
        frame k from ``at_time`` of its own tick (scene_fn), so they batch
        exactly like static scenes."""
        r = self.renderer
        poses = []
        times = None
        scene_fn = None
        if self._volume is not None:
            vs = self._volume
            scene = None
            for _ in range(self.batch):
                self._volume_input(vs, inp, dt)
                scene = vs.update(dt)
                poses.append((tuple(vs.pos), vs.yaw, vs.pitch))
            r.scene = scene
            self.camera.set_pose(tuple(vs.pos), vs.yaw, vs.pitch)
        elif self._dynamic is not None:
            dyn = self._dynamic
            times = [dyn.t + dt * (k + 1) for k in range(self.batch)]
            dyn.t = times[-1]
            scene_fn = dyn.at_time
            for _ in range(self.batch):
                if inp is not None:
                    self.camera.update(inp, dt)
                poses.append((list(self.camera.pos), self.camera.yaw,
                              self.camera.pitch))
        else:
            for _ in range(self.batch):
                if inp is not None:
                    self.camera.update(inp, dt)
                poses.append((list(self.camera.pos), self.camera.yaw,
                              self.camera.pitch))
        grids, out = r.render_many(self.batch, poses=poses, rgb=True,
                                   times=times, scene_fn=scene_fn)
        self._batch_inflight = HostCopy((*grids, out.rays_traced))

    def _update_batched(self, dt: float, inp):
        """K-frames-per-render_many app loop.

        One render_many renders K frames and one copy per plane brings
        all K cell grids to the host, so per-frame host round trips
        amortize K-fold. The cost is input latency (~K..2K ticks: input
        sampled at dispatch time shows in the batch after the one being
        blitted)."""
        t0 = time.perf_counter()
        if self._batch_cur is None or self._batch_pos >= len(self._batch_cur[0]):
            if self._batch_inflight is None:
                # Cold start (first tick / after a switch): dispatch and
                # show nothing this tick.
                self._dispatch_batch(dt, inp)
                return
            *grids, rays = self._batch_inflight.numpy()
            self._batch_inflight = None
            self._batch_cur = tuple(grids)
            self._batch_pos = 0
            self._batch_rays = int(rays)
            # Refill the pipeline at once: the next batch renders while
            # this one is blitted over the next K ticks.
            self._dispatch_batch(dt, inp)
        fg, bg, top, bot = (g[self._batch_pos] for g in self._batch_cur)
        self._batch_pos += 1
        with profiling.span("component.blit"):
            # RGB planes ship as display u8 (render_many(rgb=True)): decode.
            self.fb.blit_half_blocks(top.astype(np.float32) / 255.0,
                                     bot.astype(np.float32) / 255.0, fg, bg)
            frame_ms = (time.perf_counter() - t0) * 1000.0
            self._frame_times.append(frame_ms)
            if len(self._frame_times) > 30:
                self._frame_times.pop(0)
            if self.show_hud:
                self.info = self._info_string(self._batch_rays, frame_ms)
                self.fb.write_text(0, 0, self.info[: self.fb.width])

    def _info_string(self, rays: int, frame_ms: float) -> str:
        """HUD parity (GetInfoString, RaytraceEntity.cs:216-219)."""
        p = self.camera.pos
        avg = sum(self._frame_times) / max(1, len(self._frame_times))
        name = self.scene_names[self.scene_idx]
        return (f" {name} [{self.scene_idx + 1}/{len(self.scene_names)}] "
                f"pos({p[0]:.1f},{p[1]:.1f},{p[2]:.1f}) "
                f"yaw{self.camera.yaw:+.2f} pitch{self.camera.pitch:+.2f} "
                f"{self.fb.width}x{self.fb.height} ss{self.ss} "
                f"{rays / 1e3:.0f}k rays {avg:.0f}ms "
                f"{1000.0 / max(avg, 1e-6):.1f}fps ")
