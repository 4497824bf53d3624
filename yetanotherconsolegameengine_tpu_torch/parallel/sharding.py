"""Multi-device row sharding of the frame step.

Port of ``yetanotherconsolegameengine_tpu/parallel/sharding.py``. The
frame's traced rows are split into equal bands over the ranks of a
``torch.distributed`` group; the scene and the camera are replicated. In
JAX one jitted ``frame_step`` ran SPMD and XLA inserted the collectives;
here each rank runs ``render.renderer.frame_step`` on its band and the
collectives are explicit:

- tracing is per pixel: a band traces its rows [y0, y1) of the frame with
  the whole frame's rays, jitter and seeds (K2 or the wavefront with K3);
- the TAA clamp and the a-trous passes reach ``post_kernel.halo_rows(cfg)``
  rows (15 by default), so before the post each rank gathers the G-buffer
  and last frame's history of its extended band, the band plus that many
  rows each side, from the ranks that own them (``RowGroup.extend``: an
  all-gather of the bands, then a slice, which serves a halo that spans
  several owners);
- K1 runs as launch A over the extended band, which writes the owned rows
  and an exposure partial; the ranks' partials are summed in rank order
  (``RowGroup.combine``), so every rank holds the same exposure; launch B
  posts the owned rows.

Every rank renders the scene rank 0 holds: ``broadcast_scene`` sends it
tensor by tensor, and ``ShardedStep.scene = ...`` (called on every rank)
broadcasts a new one between steps, which is how a streamed world's new
chunks on rank 0 reach the other ranks.

Backends: NCCL keeps the exchange on the card and needs a card a rank.
Ranks that share a card use gloo, which moves CPU tensors only, so their
CUDA tensors are staged through pinned host buffers: the "host" exchange.
The two are named paths chosen by the backend; neither falls back to the
other, and NCCL with more ranks than cards raises.

``dryrun`` spawns ranks with ``torch.multiprocessing`` (a ``FileStore`` in
a temporary directory: no TCP port) and renders the reference dryrun's
scenes; ``python -m yetanotherconsolegameengine_tpu_torch.parallel.sharding
--ranks 1`` runs it on one card over NCCL (the default on CUDA), ``--ranks
4 --backend gloo`` on four ranks that share the card, ``--device cpu`` on
the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import functools
import os
import pickle
import sys
import tempfile
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import DEFAULT_CONFIG, RenderConfig
from ..core.camera import CameraPose
from ..devices import resolve_device
from ..ops import kernels, post_kernel, trace_kernel
from ..render.renderer import FrameOutput, frame_inputs, frame_step, init_state
from ..scene.tables import SceneData

BACKENDS = ("nccl", "gloo")
TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A rank's band: traced rows [y0, y1) of a frame ``height`` rows
    tall, and the ``halo`` rows each side that the post reads."""

    rank: int
    world: int
    y0: int
    y1: int
    halo: int
    height: int

    @staticmethod
    def of(rank: int, world: int, fb_h: int, ss: int,
           cfg: RenderConfig) -> "RowShard":
        check_shape(world, fb_h, ss)
        band = fb_h * 2 * ss // world
        return RowShard(rank, world, rank * band, (rank + 1) * band,
                        post_kernel.halo_rows(cfg), fb_h * 2 * ss)

    @property
    def ext(self) -> tuple:
        """The extended band, [e0, e1): the band +- halo, cut to the
        frame."""
        return max(0, self.y0 - self.halo), min(self.height,
                                                self.y1 + self.halo)

    @property
    def own(self) -> tuple:
        """The owned rows within the extended band."""
        e0 = self.ext[0]
        return self.y0 - e0, self.y1 - e0


def check_shape(world: int, fb_h: int, ss: int = 1) -> None:
    """Every rank owns an equal band of whole cells: fb_h and the traced
    height fb_h * 2 * ss must both divide by the world size."""
    hi_h = fb_h * 2 * ss
    if hi_h % world or fb_h % world:
        raise ValueError(f"fb_h={fb_h} (hi_h={hi_h}) must be divisible by "
                         f"the world size {world}")


class RowGroup:
    """This rank's place in a process group of row bands: rank, world,
    device and backend, and the collectives a sharded frame needs.

    The backend names the exchange: NCCL's keeps tensors on the card;
    gloo's stages CUDA tensors through pinned host buffers, kept per
    shape (CPU tensors are already on the host). ``exchange_device`` is
    where the collectives' tensors live, ``staged`` whether CUDA tensors
    pass through the host on the way."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str):
        self.rank, self.world = rank, world
        self.device, self.backend = device, backend
        self.staged = backend == "gloo" and device.type == "cuda"
        self.exchange_device = (device if backend == "nccl"
                                else torch.device("cpu"))
        self._buffers = {}

    def _buffer(self, key: str, shape, dtype) -> torch.Tensor:
        k = (key, tuple(shape), dtype)
        if k not in self._buffers:
            self._buffers[k] = torch.empty(shape, dtype=dtype,
                                           pin_memory=self.staged)
        return self._buffers[k]

    def gather_rows(self, t: torch.Tensor, rows=None) -> torch.Tensor:
        """The ranks' (R, ...) tensors stacked in rank order, (world * R,
        ...), cut to ``rows`` = (a, b) when given, on this rank's
        device."""
        t = t.contiguous()
        shape = (self.world * t.shape[0],) + tuple(t.shape[1:])
        if self.staged:
            send = self._buffer("send", t.shape, t.dtype)
            send.copy_(t)
            out = self._buffer("gather", shape, t.dtype)
        else:
            send = t
            out = torch.empty(shape, dtype=t.dtype, device=t.device)
        dist.all_gather(list(out.view(self.world, *t.shape).unbind(0)), send)
        if rows is not None:
            out = out[rows[0]:rows[1]]
        return out.to(self.device)

    def extend(self, shard: RowShard, gbuf: torch.Tensor,
               history: torch.Tensor):
        """This frame's G-buffer (12, R, W) and last frame's history
        (3, R, W) of every rank's band -> the extended band's
        (12, E, W) G-buffer and (3, E, W) history, contiguous."""
        band = torch.cat([gbuf, history]).transpose(0, 1)   # (R, 15, W)
        ext = self.gather_rows(band, shard.ext).transpose(0, 1)
        return ext[:12].contiguous(), ext[12:].contiguous()

    def combine(self, part: torch.Tensor, rays: torch.Tensor):
        """This rank's (2,) exposure partial and ray count -> the
        ranks' partials summed in rank order ((2,) f32, the same bits on
        every rank) and the total ray count (0-d int64)."""
        mine = torch.cat([part.to(torch.float64),
                          rays.to(torch.float64).reshape(1)])
        every = self.gather_rows(mine[None])                 # (world, 3)
        total = post_kernel.combine_partials(every[:, :2].to(torch.float32))
        return total.contiguous(), every[:, 2].sum().to(torch.int64)

    def broadcast_object(self, obj, src: int = 0):
        """``obj`` of rank ``src`` (pickled) on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src, device=self.exchange_device)
        return box[0]

    def broadcast_tensor(self, t: Optional[torch.Tensor], shape, dtype,
                         src: int = 0) -> torch.Tensor:
        """Rank ``src``'s tensor on every rank, on the exchange's device,
        sent as bytes (gloo takes few dtypes)."""
        nbytes = int(np.prod(shape, dtype=np.int64)) \
            * torch.empty((), dtype=dtype).element_size()
        buf = torch.empty(nbytes, dtype=torch.uint8,
                          device=self.exchange_device)
        out = buf.view(dtype).reshape(shape)
        if self.rank == src:
            out.copy_(t)
        if nbytes:
            dist.broadcast(buf, src)
        return out

    def barrier(self) -> None:
        dist.barrier()


def make_group(rank: int, world: int, store, backend: Optional[str] = None,
               device="cuda") -> RowGroup:
    """Join the process group of ``world`` ranks through ``store`` (a
    ``torch.distributed`` store) as ``rank``, and pick this rank's device,
    ``cuda:{rank % device_count}`` (or the CPU). ``backend`` defaults to
    "nccl" on CUDA and "gloo" on the CPU; NCCL with more ranks than cards
    raises."""
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl":
        if kind != "cuda":
            raise ValueError("the nccl backend needs device='cuda'")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"nccl with {world} ranks on {cards} card(s): NCCL takes "
                f"one rank a card; pass backend='gloo' for ranks that "
                f"share a card (their exchange stages through pinned host "
                f"memory)")
    if kind == "cuda":
        resolve_device("cuda")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    # NCCL binds its communicator to the rank's card at once (and so fails
    # here, not at the first collective); barrier() then needs no guess.
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=TIMEOUT,
                            device_id=dev if backend == "nccl" else None)
    return RowGroup(rank, world, dev, backend)


# ---- the scene on every rank -------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Slot:
    """A tensor's place in a scene sent ahead of its bytes."""

    shape: tuple
    dtype: torch.dtype


def _strip(v, out: list):
    """``v`` with every tensor replaced by a ``_Slot``, the tensors
    appended to ``out`` in field order."""
    if isinstance(v, torch.Tensor):
        out.append(v)
        return _Slot(tuple(v.shape), v.dtype)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return dataclasses.replace(v, **{
            f.name: _strip(getattr(v, f.name), out)
            for f in dataclasses.fields(v)})
    return v


def _fill(v, fetch: Callable):
    """``_strip`` undone: each ``_Slot`` replaced by ``fetch(slot)``, in
    the same field order."""
    if isinstance(v, _Slot):
        return fetch(v)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return dataclasses.replace(v, **{
            f.name: _fill(getattr(v, f.name), fetch)
            for f in dataclasses.fields(v)})
    return v


def broadcast_scene(group: RowGroup, scene: Optional[SceneData],
                    src: int = 0) -> SceneData:
    """Rank ``src``'s ``scene`` on every rank (other ranks pass None), on
    each rank's device: the scene's layout and host fields first, which
    carries which optional sets (mesh, clusters, voxels, proxies) it has
    and their shapes, then its tensors one by one in field order. A scene
    that keeps its mesh soup rebuilds its LBVH on the rank's device."""
    tensors = []
    layout = _strip(scene, tensors) if group.rank == src else None
    layout = group.broadcast_object(layout, src)
    sent = iter(tensors)
    got = _fill(layout, lambda slot: group.broadcast_tensor(
        next(sent) if group.rank == src else None, slot.shape, slot.dtype,
        src))
    return got.to(group.device)


# ---- the sharded step --------------------------------------------------------

def _one_frame(cam: CameraPose) -> CameraPose:
    """A pose of one frame as a batch of one."""
    return CameraPose(pos=cam.pos.reshape(1, 3), yaw=cam.yaw.reshape(1),
                      pitch=cam.pitch.reshape(1),
                      fov_deg=cam.fov_deg.reshape(1))


class ShardedStep:
    """One rank's frame step over a row-sharded frame:
    ``step(scene, cam, state) -> (out, state)``, where ``out`` holds this
    band's cell rows (``gather_output`` assembles the frame) and the whole
    frame's ``rays_traced``. ``scene`` is this rank's replica,
    ``step.scene``; assigning ``step.scene`` (a collective: every rank
    assigns, rank 0's value wins, the others pass None) broadcasts a new
    scene and keeps the frame state. A scene is routed as
    ``RaytraceRenderer.set_scene`` routes a static one: K2's packed
    tables when ``trace_kernel.scene_fits``, else the wavefront."""

    def __init__(self, group: RowGroup, shard: RowShard, fb_w: int,
                 fb_h: int, ss: int, cfg: RenderConfig):
        self.group, self.shard = group, shard
        self.fb_w, self.fb_h, self.ss = fb_w, fb_h, ss
        self.cfg = cfg
        self._scene = self.packed = None

    @property
    def scene(self) -> SceneData:
        return self._scene

    @scene.setter
    def scene(self, scene: Optional[SceneData]):
        scene = broadcast_scene(self.group, scene)
        self._scene = scene
        self.packed = (trace_kernel.pack_scene(scene)
                       if trace_kernel.scene_fits(scene, self.cfg)
                       else scene)

    def __call__(self, scene: SceneData, cam: CameraPose, state):
        if scene is not self._scene:
            raise ValueError("step(scene, ...) takes this rank's replica, "
                             "step.scene; to change the scene assign "
                             "step.scene on every rank")
        cams = _one_frame(cam)
        ss = self.ss
        inputs = frame_inputs(cams, state, self.fb_w * ss,
                              self.fb_h * 2 * ss, self.cfg)
        return frame_step(self.packed, cams, inputs, 0, state, self.fb_w,
                          self.fb_h, ss, self.cfg, shard=self.shard,
                          group=self.group)


def make_sharded_step(group: RowGroup, scene: Optional[SceneData],
                      fb_w: int, fb_h: int, ss: int = 1,
                      cfg: RenderConfig = DEFAULT_CONFIG):
    """The row-sharded frame step of this rank. ``scene``: rank 0's
    scene (other ranks may pass None), broadcast to every rank. Returns
    (step, this rank's scene replica, this rank's band of a fresh frame
    state). fb_h * 2 * ss and fb_h must divide by the world size."""
    shard = RowShard.of(group.rank, group.world, fb_h, ss, cfg)
    step = ShardedStep(group, shard, fb_w, fb_h, ss, cfg)
    step.scene = scene
    state = init_state(fb_w, fb_h, ss, group.device, shard=shard)
    return step, step.scene, state


def gather_output(group: RowGroup, out: FrameOutput) -> FrameOutput:
    """The whole frame's FrameOutput on every rank, from each rank's
    band."""
    g = group.gather_rows
    return FrameOutput(top_rgb=g(out.top_rgb), bot_rgb=g(out.bot_rgb),
                       fg_ansi=g(out.fg_ansi), bg_ansi=g(out.bg_ansi),
                       rays_traced=out.rays_traced)


def cluster_test_scene(subdiv: int = 4) -> SceneData:
    """A small scene forced onto the cluster path (K3 at toy sizes):
    ``scene.mesh_scenes.build_cluster_forced_scene``, the JAX package's
    ``cluster_test_scene``."""
    from ..scene.mesh_scenes import build_cluster_forced_scene
    return build_cluster_forced_scene(subdiv)


def run_sharded_frames(group: RowGroup, scene, fb_w: int, fb_h: int,
                       n_frames: int = 2, ss: int = 1,
                       cfg: RenderConfig = DEFAULT_CONFIG):
    """``n_frames`` sharded steps from the scene's default pose. ``scene``
    is rank 0's (the other ranks pass None): a SceneData, or an iterator
    whose k-th item is frame k's scene (a streamed world: each new item is
    assigned, so broadcast, before its frame). Returns (this rank's last
    FrameOutput, the step, its state)."""
    stream = group.broadcast_object(
        scene is not None and not isinstance(scene, SceneData))
    first = next(scene) if stream and group.rank == 0 else scene
    step, _, state = make_sharded_step(group, first, fb_w, fb_h, ss, cfg)
    out = None
    for k in range(n_frames):
        if stream and k:
            step.scene = next(scene) if group.rank == 0 else None
        out, state = step(step.scene, step.scene.default_pose, state)
    return out, step, state


# ---- spawned ranks -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FrameJob:
    """Frames of one scene for ``frames_job``. ``build`` (picklable; run
    on rank 0 only) returns a SceneData, or an iterator whose k-th item is
    frame k's scene (a streamed world: each new item is assigned, so
    broadcast, before its frame). ``n_frames`` sharded steps at
    ``fb_w`` x ``fb_h`` from the scene's default pose, then ``timed``
    more frames timed by CUDA events."""

    name: str
    build: Callable
    fb_w: int
    fb_h: int
    n_frames: int = 2
    ss: int = 1
    timed: int = 0


def frames_job(group: RowGroup, jobs,
               cfg: RenderConfig = DEFAULT_CONFIG) -> dict:
    """Run each ``FrameJob`` on this rank. Returns {"launches": {name:
    this rank's kernel launches in the n_frames steps}, "ms": {name:
    ms/frame of the timed frames by this rank's CUDA events}, "frames":
    {name: the last frame gathered, as numpy arrays}}."""
    res = {"launches": {}, "ms": {}, "frames": {}}
    for job in jobs:
        src = job.build() if group.rank == 0 else None
        try:
            kernels.reset_launches()
            out, step, state = run_sharded_frames(
                group, src, job.fb_w, job.fb_h, job.n_frames, job.ss, cfg)
            res["launches"][job.name] = dict(kernels.LAUNCHES)
            full = gather_output(group, out)
            res["frames"][job.name] = {
                f.name: getattr(full, f.name).cpu().numpy()
                for f in dataclasses.fields(full)}
            if job.timed:
                res["ms"][job.name] = _timed(step, state, job.timed)
        finally:
            if src is not None and not isinstance(src, SceneData):
                src.close()
    return res


def _timed(step: ShardedStep, state, n: int) -> float:
    """ms/frame of ``n`` more steps by this rank's CUDA events, the ranks
    started together."""
    if step.group.device.type != "cuda":
        raise ValueError("timed frames are measured on a CUDA device")
    scene = step.scene
    cam = scene.default_pose
    torch.cuda.synchronize()
    step.group.barrier()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        _, state = step(scene, cam, state)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def _worker(rank: int, world: int, tmp: str, device: str,
            backend: Optional[str], job: Callable, args: tuple) -> None:
    """One spawned rank: join the group through the FileStore in ``tmp``,
    run ``job(group, *args)`` and pickle its result to ``tmp``."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    group = make_group(rank, world, store, backend, device)
    try:
        result = job(group, *args)
        with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(n_ranks: int, job: Callable, *args, device="cuda",
          backend: Optional[str] = None) -> list:
    """Run ``job(group, *args)`` (a picklable function) on ``n_ranks``
    spawned ranks; returns the ranks' results in rank order. A rank's
    exception stops the others and is raised here
    (``torch.multiprocessing.ProcessRaisedException``)."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            _worker, args=(n_ranks, tmp, device, backend, job, args),
            nprocs=n_ranks, join=True)
        results = []
        for r in range(n_ranks):
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def volume_frames(world_cfg, world_path: str, dt: float = 1.0 / 30.0,
                  device="cuda"):
    """Frame k's scene of a streamed island (``build_minecraft_like``
    generated into ``world_path``): ``VolumeScene.update(dt)`` per frame,
    seen from 10 above the player looking down. A generator for
    ``FrameJob.build`` (through ``functools.partial``) on rank 0; closing
    it shuts the chunk manager down."""
    from ..world.volume_scene import build_minecraft_like
    vs = build_minecraft_like(world_cfg, world_path=world_path,
                              regenerate=True, device=device)
    try:
        while True:
            scene = vs.update(dt)
            (x, y, z), yaw, _ = vs.camera
            yield dataclasses.replace(scene, defaults=(
                float(x), float(y) + 10.0, float(z), float(yaw), -0.9,
                scene.defaults[5]))
    finally:
        vs.manager.shutdown()


def dryrun_scenes() -> list:
    """The reference dryrun's scenes: Cornell (K2), the forced cluster
    mesh (the wavefront with K3) and the voxel room on the DDA."""
    from ..scene.builders import build_cornell_box
    from ..scene.voxel_scenes import build_voxel_test_scene
    return [("cornell", build_cornell_box),
            ("mesh_clusters", functools.partial(cluster_test_scene, 3)),
            ("voxel_dda", functools.partial(build_voxel_test_scene,
                                            merge="dda"))]


def dryrun(n_ranks: int, fb_w: int = 32, fb_h: Optional[int] = None,
           device="cuda", backend: Optional[str] = None) -> list:
    """Sharded frames over every traversal path on ``n_ranks`` spawned
    ranks (fb_h defaults to 2 * n_ranks): each scene must run two steps
    and give finite pixels on every rank. Raises if a rank raises.
    Returns the ranks' ``frames_job`` results."""
    jobs = [FrameJob(name, build, fb_w, fb_h or 2 * n_ranks)
            for name, build in dryrun_scenes()]
    res = spawn(n_ranks, frames_job, jobs, device=device, backend=backend)
    for rank, r in enumerate(res):
        for name, frame in r["frames"].items():
            if not (np.isfinite(frame["top_rgb"]).all()
                    and np.isfinite(frame["bot_rgb"]).all()):
                raise RuntimeError(f"{name}: non-finite pixels on rank "
                                   f"{rank}")
    return res


def dryrun_multichip(n_devices: int) -> list:
    """The counterpart of ``__graft_entry__.dryrun_multichip``: the dryrun
    on ``n_devices`` ranks of the card at 32 x (2 * n_devices) cells."""
    return dryrun(n_devices, fb_w=32, fb_h=2 * n_devices)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=BACKENDS, default=None)
    a = ap.parse_args(argv)
    res = dryrun(a.ranks, device=a.device, backend=a.backend)
    for name, frame in res[0]["frames"].items():
        h, w = frame["top_rgb"].shape[:2]
        print(f"{name}: {a.ranks} ranks, {w}x{h} cells, finite; launches "
              f"by rank {[r['launches'][name] for r in res]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
