"""The port's app shell against the JAX package's: the ANSI encoders (the
port's native library, its Python fallback and the JAX package's
encoders give the same bytes), input parsing, the fly camera, chexel
compose and PNG export, the headless program on the CPU, the batched
component against the unbatched one, and scene swaps by assignment."""

import ctypes
import os

import numpy as np
import pytest
import torch

from yetanotherconsolegameengine_tpu.engine import chexel as jchexel
from yetanotherconsolegameengine_tpu.engine import fly_camera as jfly
from yetanotherconsolegameengine_tpu.engine import input as jinput
from yetanotherconsolegameengine_tpu.engine import terminal_renderer as jtr
from yetanotherconsolegameengine_tpu.native import load as jload
from yetanotherconsolegameengine_tpu.utils import png as jpng
from yetanotherconsolegameengine_tpu_torch import native
from yetanotherconsolegameengine_tpu_torch.engine import (chexel, fly_camera,
                                                          input as pinput,
                                                          terminal_renderer)
from yetanotherconsolegameengine_tpu_torch.engine.chexel import (HALF_BLOCK,
                                                                 Framebuffer)
from yetanotherconsolegameengine_tpu_torch.engine.raytrace_entity import (
    HostCopy, RaytraceComponent, default_scene_order)
from yetanotherconsolegameengine_tpu_torch.render.renderer import (
    RaytraceRenderer)
from yetanotherconsolegameengine_tpu_torch.scene.builders import SCENE_BUILDERS
from yetanotherconsolegameengine_tpu_torch.utils import png

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

_P = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _grids(seed, h, w, runs=False):
    rs = np.random.RandomState(seed)
    g = np.full((h, w), HALF_BLOCK, np.int32)
    g[rs.rand(h, w) < 0.1] = ord("x")
    f = rs.randint(0, 256, (h, w)).astype(np.int32)
    b = rs.randint(0, 256, (h, w)).astype(np.int32)
    if runs:                       # long runs of one color
        f //= 64
        b //= 64
    return g, f, b


def _native_encode(lib, g, f, b, origin=1):
    h, w = g.shape
    buf = (ctypes.c_uint8 * lib.yacge_ansi_max_bytes(w, h))()
    n = lib.yacge_ansi_encode(_P(g), _P(f), _P(b), w, h, origin, buf)
    return bytes(buf[:n])


def test_native_encoder_builds_into_the_build_dir():
    lib = native.load()
    assert lib is not None, "g++ build of ansi_encoder.cpp failed"
    assert native._so_path().is_file()
    assert native._so_path().parent == native.BUILD_DIR


@pytest.mark.parametrize("h,w,runs,origin", [(12, 20, False, 1),
                                             (28, 48, True, 3),
                                             (1, 1, False, 1)])
def test_encoders_give_the_jax_bytes(h, w, runs, origin):
    """The port's native encoder, its Python fallback and both JAX-package
    encoders: one byte stream."""
    g, f, b = _grids(h * w, h, w, runs)
    want = jtr._py_encode(g, f, b, origin)
    assert _native_encode(native.load(), g, f, b, origin) == want
    assert terminal_renderer._py_encode(g, f, b, origin) == want
    assert _native_encode(jload(), g, f, b, origin) == want


def test_diff_encoder_equals_jax():
    lib, jlib = native.load(), jload()
    g, f, b = _grids(5, 8, 16)
    f2 = f.copy()
    f2[3, 7] = (f2[3, 7] + 1) % 256
    f2[6, 0] = (f2[6, 0] + 9) % 256
    outs = []
    for L in (lib, jlib):
        buf = (ctypes.c_uint8 * L.yacge_ansi_max_bytes(16, 8))()
        same = L.yacge_ansi_encode_diff(_P(g), _P(f), _P(b), _P(g), _P(f),
                                        _P(b), 16, 8, 1, buf)
        n = L.yacge_ansi_encode_diff(_P(g), _P(f2), _P(b), _P(g), _P(f),
                                     _P(b), 16, 8, 1, buf)
        outs.append((same, bytes(buf[:n])))
    assert outs[0] == outs[1] and outs[0][0] == -1
    assert b"\x1b[4;8H" in outs[0][1]


def _read_all(r):
    data = b""
    while chunk := os.read(r, 1 << 20):
        data += chunk
    return data


def _fill(fb_mod, seed):
    fb = fb_mod.Framebuffer(20, 6)
    rs = np.random.RandomState(seed)
    top = rs.rand(6, 20, 3).astype(np.float32)
    fb.blit_half_blocks(top, top * 0.5, rs.randint(16, 256, (6, 20)),
                        rs.randint(16, 256, (6, 20)))
    fb.write_text(1, 0, "HUD", fg_ansi=10, bg_ansi=2)
    return fb


def test_ansi_backend_frames_equal_jax():
    """Two frames through each package's ANSI backend (full, then diff)
    into a pipe: the same bytes."""
    outs = []
    for tr, ch in ((terminal_renderer, chexel), (jtr, jchexel)):
        r, w = os.pipe()
        be = tr.ANSITerminalRenderer(out_fd=w)
        be.console_size = lambda: (20, 6)
        be.add_framebuffer(_fill(ch, 1))
        be.render()
        be.framebuffers[0] = _fill(ch, 2)
        be.render()
        os.close(w)
        outs.append(_read_all(r))
        os.close(r)
    assert outs[0] == outs[1] and b"\x1b[38;5;" in outs[0]


def test_compose_and_png_equal_jax():
    fbs = []
    for ch in (chexel, jchexel):
        back = _fill(ch, 3)
        front = ch.Framebuffer(4, 2, offset_x=5, offset_y=2)
        front.write_text(0, 0, "AB", fg_ansi=9, bg_ansi=1)
        fbs.append(ch.compose([front, back], 20, 6))
    for plane in ("glyph", "fg_rgb", "bg_rgb", "fg_ansi", "bg_ansi"):
        np.testing.assert_array_equal(getattr(fbs[0], plane),
                                      getattr(fbs[1], plane), err_msg=plane)
    np.testing.assert_array_equal(
        png.frame_to_image(fbs[0].fg_rgb, fbs[0].bg_rgb, scale=2),
        jpng.frame_to_image(fbs[1].fg_rgb, fbs[1].bg_rgb, scale=2))


@pytest.mark.parametrize("data", [b"wa\x1b[A\x1b[D\x1b", b"qe \x1bOB\x1bOCz",
                                  b"\x1b[<0;10;5M\x1b[<64;1;1M\x1b[<65;3;4m",
                                  b"\x03ip\x1b[B"])
def test_input_parsing_equals_jax(data):
    got = []
    for mod in (pinput, jinput):
        r, w = os.pipe()
        os.write(w, data)
        os.close(w)
        inp = mod.TerminalInput(fd=r)
        inp.enable_mouse = True
        inp.update()
        os.close(r)
        keys, mice = [], []
        while (k := inp.try_get_key()) is not None:
            keys.append(k)
        while (m := inp.try_get_mouse()) is not None:
            mice.append((m.button, m.x, m.y, m.pressed, m.wheel))
        got.append((keys, mice, sorted(k for k in "wasdqe" if
                                       inp.is_key_down(k))))
    assert got[0] == got[1]
    assert got[0][0] or got[0][1]


class _Keys:
    def __init__(self, keys):
        self.keys = set(keys)

    def is_key_down(self, k):
        return k in self.keys


def test_fly_camera_equals_jax():
    """The same key and mouse sequence moves both cameras alike."""
    seq = [("w",), ("w", "shift"), ("a", "q"), ("left", "up"), ("d", "e"),
           ("right", "down", "s")]
    cams = [m.FlyCamera(pos=(0.5, 1.0, 2.0), yaw=0.3, pitch=-0.1)
            for m in (fly_camera, jfly)]
    for i, keys in enumerate(seq):
        for cam in cams:
            cam.update(_Keys(keys), 0.1 + 0.01 * i)
        assert cams[0].pos == cams[1].pos
        assert (cams[0].yaw, cams[0].pitch) == (cams[1].yaw, cams[1].pitch)
    for cam in cams:
        cam.toggle_orbit()
        cam.handle_mouse(pinput.MouseEvent(0, 10, 5, True))
        cam.handle_mouse(pinput.MouseEvent(0, 14, 7, True))
        cam.handle_mouse(pinput.MouseEvent(0, 0, 0, False, wheel=1))
        cam.update(_Keys(("w",)), 0.1)
    assert cams[0].pos == cams[1].pos and cams[0].yaw == cams[1].yaw


def test_scene_table_equals_jax():
    from yetanotherconsolegameengine_tpu.engine.raytrace_entity import (
        default_scene_order as jorder)
    from yetanotherconsolegameengine_tpu.scene.builders import (
        SCENE_BUILDERS as JBUILDERS)
    assert sorted(SCENE_BUILDERS) == sorted(JBUILDERS)
    assert default_scene_order() == jorder()


def _run_program(argv):
    from yetanotherconsolegameengine_tpu_torch.engine.program import main
    r, w = os.pipe()
    old = os.dup(1)
    os.dup2(w, 1)
    try:
        rc = main(argv)
    finally:
        os.dup2(old, 1)
        os.close(old)
        os.close(w)
    data = _read_all(r)
    os.close(r)
    return rc, data


@pytest.mark.parametrize("batch", ["1", "2"])
def test_program_headless_runs_on_the_cpu(batch):
    """The full app loop, non-interactive, writing ANSI to a pipe
    (tests/test_engine.py:154 on the port)."""
    rc, data = _run_program(["--scene", "test", "--frames", "3", "--size",
                             "24x14", "--no-world", "--non-interactive",
                             "--device", "cpu", "--batch", batch])
    assert rc == 0
    assert b"\x1b[38;5;" in data
    assert "▀".encode() in data
    assert b"fps" in data
    assert b"test" in data and b"[1/" in data   # the HUD's scene name


def test_program_profile_writes_a_trace(tmp_path):
    rc, _ = _run_program(["--scene", "cornell", "--frames", "2", "--size",
                          "12x8", "--no-world", "--non-interactive",
                          "--device", "cpu", "--profile", str(tmp_path)])
    assert rc == 0
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_no_fallback_hides_the_card(monkeypatch):
    """Without --device cpu the shell wants the card and says so; a window
    backend without pygame raises instead of showing another backend."""
    from yetanotherconsolegameengine_tpu_torch.engine.terminal import Terminal
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            RaytraceComponent(Framebuffer(8, 6), scene_names=["test"])
    monkeypatch.delitem(terminal_renderer.BACKENDS, "window", raising=False)
    with pytest.raises(RuntimeError, match="pygame"):
        Terminal(backend="window", interactive=False)


def _blits(comp, fb, ticks):
    seq = []
    for _ in range(ticks):
        comp.update(1.0 / 30.0)
        seq.append((fb.fg_ansi.copy(), fb.bg_ansi.copy(), fb.fg_rgb.copy(),
                    fb.bg_rgb.copy()))
    comp.close()
    return seq


@pytest.mark.parametrize("scene,batch,w,h,ticks", [
    ("test", 4, 24, 14, 6), ("spinning_mesh", 3, 20, 12, 5)])
def test_batched_component_matches_unbatched(scene, batch, w, h, ticks):
    """--batch K only pipelines: the batched component blits the frame
    sequence of the unbatched one (both show frame t-1 at tick t), fg/bg
    bit-equal, RGB within the display-u8 quantization
    (tests/test_engine.py:181,218 on the port)."""
    seqs = {}
    for k in (1, batch):
        fb = Framebuffer(w, h)
        c = RaytraceComponent(fb, scene_names=[scene], enable_world=False,
                              batch=k, device="cpu")
        c.show_hud = False
        seqs[k] = _blits(c, fb, ticks)
    for t in range(1, ticks):     # tick 0 blits nothing on both paths
        for i, (a, b) in enumerate(zip(seqs[batch][t], seqs[1][t])):
            if i < 2:
                np.testing.assert_array_equal(a, b, err_msg=f"tick {t}")
            else:
                np.testing.assert_allclose(a, b, atol=1 / 255.0,
                                           err_msg=f"tick {t}")
    assert seqs[1][-1][2].max() > 0.0


def test_scene_swap_by_assignment_changes_the_frame():
    """``renderer.scene = other`` renders the other scene from the next
    frame on, with the frame state kept (the shell swaps a streamed or
    animated scene every tick this way)."""
    r = RaytraceRenderer(SCENE_BUILDERS["cornell"](), 16, 10, device="cpu")
    first = r.render().top_rgb.clone()
    again = r.render().top_rgb.clone()
    r.scene = SCENE_BUILDERS["glass"]()
    assert r.state.frame_idx == 2               # history kept
    swapped = r.render().top_rgb
    # Cornell's frames converge (mean change ~0.04-0.06 a frame); the
    # glass scene is another image (mean change ~0.34).
    step = float((again - first).abs().mean())
    assert float((swapped - again).abs().mean()) > 3 * step
    # Under static=False even a scene that fits stays on the wavefront.
    r.set_scene(SCENE_BUILDERS["cornell"](), static=False)
    assert r.packed is r.scene
    r.scene = SCENE_BUILDERS["glass"]()
    assert r.packed is r.scene
    r.set_scene(SCENE_BUILDERS["cornell"]())
    assert r.packed is not r.scene


def test_component_switches_scenes_and_shows_the_hud():
    fb = Framebuffer(24, 14)
    c = RaytraceComponent(fb, scene_names=["test", "exhibit_ring"],
                          enable_world=False, device="cpu")
    for _ in range(2):
        c.update(1.0 / 30.0)
    assert "test [1/2]" in c.info and "rays" in c.info
    c._switch_to(1, force=True)
    assert c._dynamic is not None and c.renderer.static is False
    for _ in range(2):
        c.update(1.0 / 30.0)
    assert "exhibit_ring [2/2]" in c.info
    assert c._dynamic.t == pytest.approx(2.0 / 30.0)
    assert (fb.glyph[1:] == HALF_BLOCK).all()
    assert c.handle_key("v")                     # video mode on the CPU
    c.update(1.0 / 30.0)
    assert c._video.device == torch.device("cpu")
    c.close()


def test_host_copy_on_the_cpu():
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    (got,) = HostCopy([x]).numpy()
    np.testing.assert_array_equal(got, x.numpy())
