"""The comparison that decides ``correct``.

Once the window has closed, the reference (``benchmark/reference``)
renders again every render call the shell kept. It follows one unbroken
run of calls from a fresh state with its own state: every call of the
set-up and the window's first ``follow_calls``, so an error that builds up
in the TAA history or the exposure over many frames shows. It also renders
a sample of the window's later calls, drawn from the seed, each from the
frame state the program held before it (the reference cannot afford to
follow thousands of frames, so it checks each sampled step on its own:
the state after the step is compared too). It replays the key schedule
for the poses and takes nothing else of the program's: its scene comes
from its own builder, its rays, seeds, triangle order, post and ANSI from
its own code. The numbers, each the
worst over the kept calls and frames:

- ``input_diff``: values of the program's scene tables (valid rows,
  materials, sky, camera defaults, mesh soup or cluster sets) unequal to
  the reference builder's, and render settings unequal to the
  configuration's (``cluster_rows`` says how cluster sets compare);
- ``sequence_errors``: kept calls whose tick, frame count or first frame
  index differ from the reference's replay of the shell loop;
- ``pose_diff``: the largest gap between the program's last pose after a
  call and the replayed one;
- ``rgb_mae``: the mean absolute gap of the blitted '▀' colours (top and
  bottom pixel of every cell) to the reference's;
- ``ansi_flips``: the share of cells whose blitted fg or bg ANSI index
  differs from the reference's;
- ``screen_flips``: the share of cells, below the HUD row, that a terminal
  fed the encoder's bytes over the screen before shows other than '▀' in
  the reference's colours;
- ``history_mae``: the mean absolute gap of the TAA history after a call;
- ``exposure_rel``: the relative gap of the auto-exposure after a call.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import camera, frame, scene as ref_scene
from .reference.terminal import Screen

HALF_BLOCK = 0x2580
NUMBERS = ("input_diff", "sequence_errors", "pose_diff", "rgb_mae",
           "ansi_flips", "screen_flips", "history_mae", "exposure_rel")
# What the lower-precision control can be held to: the numbers of the
# frame and its state.
CONTROL_NUMBERS = ("rgb_mae", "ansi_flips", "history_mae", "exposure_rel")


# The program's cluster tables of each set of a cluster mesh.
CLUSTER_TABLES = {"mesh": "mesh_clusters", "mesh_fine": "mesh_clusters_fine",
                  "mesh_lod": "mesh_clusters_lod",
                  "mesh_shadow": "mesh_clusters_shadow"}


def cluster_rows(a, e1, e2, n, mat) -> np.ndarray:
    """A set's triangles as sorted float64 rows (a, e1, e2, n, mat): a form
    that no packing order changes, compared exactly. Every column can
    match bit for bit: the program packs a as given, e1 and e2 as float32
    differences from it and n by the expression of ``_normals``."""
    rows = np.concatenate([a, e1, e2, n, np.asarray(mat)[:, None]],
                          axis=1).astype(np.float64)
    return rows[np.lexsort(rows.T[::-1])]


def _normals(e1, e2):
    n = np.cross(e1, e2)
    return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)


def as_compared(inputs: dict) -> dict:
    """The reference builder's inputs in the form ``program_inputs``
    gives: each cluster set's vertices as ``cluster_rows``."""
    out = dict(inputs)
    for name in CLUSTER_TABLES:
        if f"{name}.kc" not in inputs:
            continue
        a, b, c, mat = (out.pop(f"{name}.{k}") for k in ("a", "b", "c",
                                                         "mat"))
        e1, e2 = b - a, c - a
        out[f"{name}.rows"] = cluster_rows(a, e1, e2, _normals(e1, e2), mat)
    return out


def program_inputs(scene) -> dict:
    """The program's scene as the reference builder's keys (valid rows; a
    cluster set's triangles as ``cluster_rows``, read from its packed
    rows without the zero rows that pad its last cluster, beside its
    triangles a cluster and its ``t_bias``)."""
    out = {}
    for t, cols in ref_scene.TABLES.items():
        tb = getattr(scene, t)
        mask = tb.mask.cpu().numpy()
        for c, _, _ in cols:
            out[f"{t}.{c}"] = getattr(tb, c).cpu().numpy()[mask]
    for f in ref_scene.MATERIAL_FIELDS:
        out[f"materials.{f}"] = getattr(scene.materials, f).cpu().numpy()
    for v in ref_scene.VECTORS:
        out[v] = getattr(scene, v).cpu().numpy()
    out["defaults"] = np.asarray(scene.defaults, np.float64)
    if scene.mesh_soup is not None:
        for k in ("a", "b", "c", "mat"):
            out[f"mesh.{k}"] = getattr(scene.mesh_soup, k).cpu().numpy()
    for name, table in CLUSTER_TABLES.items():
        mc = getattr(scene, table)
        if mc is None:
            continue
        rows = mc.tri_rows.cpu().numpy()
        used = np.flatnonzero(rows.any(axis=1))
        rows = rows[:used[-1] + 1 if used.size else 0]
        out[f"{name}.rows"] = cluster_rows(rows[:, 0:3], rows[:, 3:6],
                                           rows[:, 6:9], rows[:, 9:12],
                                           rows[:, 12])
        out[f"{name}.kc"] = np.asarray(mc.kc, np.int32)
        out[f"{name}.t_bias"] = np.asarray(mc.t_bias, np.float64)
    return out


def scene_diff(got: dict, want: dict) -> int:
    bad = 0
    for k in set(got) | set(want):
        a, b = got.get(k), want.get(k)
        if a is None or b is None or a.shape != b.shape:
            bad += 1 if a is None or b is None else max(a.size, b.size, 1)
        else:
            bad += int(np.count_nonzero(a.astype(np.float64)
                                        != b.astype(np.float64)))
    return bad


def settings_diff(program_cfg, cell) -> int:
    """Render settings of the program unequal to the configuration's."""
    import dataclasses
    got = dataclasses.asdict(program_cfg)
    want = cell.config["render_config"]
    return sum(got.get(k) != v for k, v in want.items()) \
        + len(set(got) - set(want))


class Reference:
    """The reference renderer of one cell, on ``device`` in ``dtype``."""

    def __init__(self, cell, inputs: dict, cfg: dict, keys_at, device,
                 dtype=torch.float32):
        self.cell, self.cfg, self.device, self.dtype = cell, cfg, device, \
            dtype
        self.scene = ref_scene.Scene.from_inputs(inputs, device, dtype)
        self.batch = int(cell.traffic["batch"])
        self.keys_at = keys_at

    def poses(self, calls: int):
        return camera.call_poses(self.keys_at, self.batch,
                                 float(self.cell.traffic["dt"]),
                                 self.scene.defaults, calls)

    def run(self, rec, replay, state=None):
        """Reference frames and state after of the kept call ``rec``, from
        ``state`` (the reference's own after the call before), else from
        a fresh state for the first call and from the program's state
        before the call for any other."""
        c = self.cell.config
        dev, dt = self.device, self.dtype
        if state is None and rec.call == 0:
            state = frame.init_state(c["fb_w"] * c["ss"],
                                     2 * c["fb_h"] * c["ss"], dev, dt)
        elif state is None:
            b = rec.before
            pos, yaw, pitch = replay[rec.call - 1][1][-1]
            to = lambda x: x.to(dev, dt)
            state = dict(history=to(b.history), prev_gbuf=to(b.prev_gbuf),
                         history_valid=b.history_valid.to(dev),
                         ae=to(b.ae_exposure),
                         last_cam=torch.tensor(pos, dtype=dt, device=dev),
                         last_yaw=torch.tensor(yaw, dtype=dt, device=dev),
                         last_pitch=torch.tensor(pitch, dtype=dt,
                                                 device=dev),
                         have_last=b.have_last.to(dev))
        return frame.render_frames(self.scene, self.cfg, c["fb_w"],
                                   c["fb_h"], replay[rec.call][1],
                                   self.scene.defaults[5], state,
                                   rec.call * self.batch + 1)


def _shown(rec, k, ref_frame):
    """What the shell would blit of a reference frame, as numpy."""
    top, bot, fg, bg, _ = ref_frame
    if rec.rgb:
        u8 = lambda x: ((torch.clamp(x.float(), 0.0, 1.0) * 255.0 + 0.5)
                        .to(torch.uint8).cpu().numpy().astype(np.float32)
                        / 255.0)
        top, bot = u8(top), u8(bot)
    else:
        top, bot = top.float().cpu().numpy(), bot.float().cpu().numpy()
    return top, bot, fg.cpu().numpy(), bg.cpu().numpy()


def _frame_numbers(got, want) -> dict:
    top, bot, fg, bg = (np.asarray(x) for x in got)
    wtop, wbot, wfg, wbg = want
    rgb = 0.5 * (np.abs(top.astype(np.float64) - wtop).mean()
                 + np.abs(bot.astype(np.float64) - wbot).mean())
    flips = np.mean((fg.astype(np.int64) != wfg) | (bg.astype(np.int64)
                                                     != wbg))
    return {"rgb_mae": float(rgb), "ansi_flips": float(flips)}


def _screen_flips(shot, want, fb_w, fb_h) -> float:
    prev, data = shot
    rows = fb_h + 1
    if prev is None:
        screen = Screen(np.full((rows, fb_w), 0x20), np.zeros((rows, fb_w)),
                        np.zeros((rows, fb_w)))
    else:
        screen = Screen(*prev)
    screen.feed(data)
    _, _, wfg, wbg = want
    g, f, b = (x[1:fb_h] for x in (screen.glyph, screen.fg, screen.bg))
    bad = (g != HALF_BLOCK) | (f != wfg[1:fb_h]) | (b != wbg[1:fb_h])
    return float(bad.mean())


def _state_numbers(after, ref_state) -> dict:
    h = after["history"] if isinstance(after, dict) else after.history
    ae = after["ae"] if isinstance(after, dict) else after.ae_exposure
    wh, wae = ref_state["history"].double(), ref_state["ae"].double()
    hd = (h.to(wh.device).double() - wh).abs().mean()
    ed = (ae.to(wae.device).double() - wae).abs() / wae.abs().clamp(min=1e-30)
    return {"history_mae": float(hd), "exposure_rel": float(ed)}


def scene_inputs(cell) -> dict:
    """The reference builder's inputs of the cell's scene."""
    import importlib
    return importlib.import_module(
        f"{__package__}.reference.scenes.{cell.config['scene']}").build()


def input_diff(renderer, cell, inputs=None) -> int:
    """``input_diff`` of the program's renderer (its scene and settings);
    ``inputs``: ``scene_inputs(cell)``, if already built."""
    if inputs is None:
        inputs = scene_inputs(cell)
    return (scene_diff(program_inputs(renderer.scene), as_compared(inputs))
            + settings_diff(renderer.cfg, cell))


def compare(shell, cell, device, control: bool = False,
            inputs=None) -> dict:
    """The numbers of ``NUMBERS`` but ``input_diff`` for the shell's kept
    calls (with ``control``, of ``CONTROL_NUMBERS`` for the reference in
    bfloat16 put in the program's place), plus ``frames_checked``;
    ``inputs``: ``scene_inputs(cell)``, if already built."""
    if inputs is None:
        inputs = scene_inputs(cell)
    cfg = dict(cell.config["render_config"])
    ref = Reference(cell, inputs, cfg, shell.schedule.keys_at, device)
    recs = sorted(shell.records + shell.sampled, key=lambda r: r.call)
    followed = {id(r) for r in shell.records}
    assert [r.call for r in shell.records] == list(range(len(shell.records)))
    replay = ref.poses(max(r.call for r in recs) + 1)
    own = low_own = None   # each reference's state along the followed run
    low = Reference(cell, inputs, cfg, shell.schedule.keys_at, device,
                    torch.bfloat16) if control else None
    fb_w, fb_h = cell.config["fb_w"], cell.config["fb_h"]
    worst = dict.fromkeys(CONTROL_NUMBERS if control else NUMBERS[1:], 0.0)
    if not control:
        worst["sequence_errors"] = 0
    frames = 0
    for rec in recs:
        follow = id(rec) in followed
        frames_ref, state_ref = ref.run(rec, replay, own if follow else None)
        if follow:
            own = state_ref
        if control:
            got_frames, got_state = low.run(rec, replay,
                                            low_own if follow else None)
            if follow:
                low_own = got_state
            blits = [_shown(rec, k, f) for k, f in enumerate(got_frames)]
            after = got_state
        else:
            blits, after = rec.blits, rec.after
            tick, poses = replay[rec.call]
            seq = (tick != rec.tick or len(poses) != rec.n
                   or rec.before.frame_idx != rec.call * ref.batch)
            worst["sequence_errors"] += int(seq)
            pos, yaw, pitch = poses[-1]
            got = torch.cat([after.last_cam.reshape(3),
                             after.last_yaw.reshape(1),
                             after.last_pitch.reshape(1)]).cpu().double()
            gap = (got - torch.tensor([*pos, yaw, pitch],
                                      dtype=torch.float64)).abs().max()
            worst["pose_diff"] = max(worst["pose_diff"], float(gap))
        for k, fr in enumerate(frames_ref):
            want = _shown(rec, k, fr)
            nums = _frame_numbers(blits[k], want)
            if not control:
                nums["screen_flips"] = (
                    1.0 if rec.screens[k] is None
                    else _screen_flips(rec.screens[k], want, fb_w, fb_h))
            for key, v in nums.items():
                worst[key] = max(worst[key], v)
            frames += 1
        for key, v in _state_numbers(after, state_ref).items():
            worst[key] = max(worst[key], v)
    worst["frames_checked"] = frames
    return worst
