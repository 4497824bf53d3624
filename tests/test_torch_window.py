"""The port's windowed (SDL) backend against the JAX package's, headless
under SDL's dummy video driver: the composed pixels, the sRGB encode and
the wheel-driven grid resize."""

import numpy as np
import pytest

pygame = pytest.importorskip("pygame")

# terminal_renderer first: it registers the window backend at its end,
# which a first import of window_renderer would find half-initialized.
from yetanotherconsolegameengine_tpu_torch.engine.terminal_renderer import (  # noqa: E402
    BACKENDS)
from yetanotherconsolegameengine_tpu.engine import terminal_renderer  # noqa: E402,F401
from yetanotherconsolegameengine_tpu.engine import chexel as jchexel  # noqa: E402
from yetanotherconsolegameengine_tpu.engine import window_renderer as jwin  # noqa: E402
from yetanotherconsolegameengine_tpu_torch.engine import chexel  # noqa: E402
from yetanotherconsolegameengine_tpu_torch.engine import window_renderer as pwin  # noqa: E402


def _backend(win, ch, cells_w, cells_h, seed=7):
    r = win.WindowTerminalRenderer(cells_w=cells_w, cells_h=cells_h)
    fb = ch.Framebuffer(*r.console_size())
    h, w = fb.height, fb.width
    rs = np.random.RandomState(seed)
    top = (rs.rand(h, w, 3) * 1.2 - 0.1).astype(np.float32)
    bot = rs.rand(h, w, 3).astype(np.float32)
    fb.blit_half_blocks(top, bot, np.full((h, w), 15), np.zeros((h, w)))
    fb.write_text(2, 1, "HUD", fg=(1.0, 0.5, 0.0))
    r.add_framebuffer(fb)
    return r


def test_registered_backend():
    assert BACKENDS["window"] is pwin.WindowTerminalRenderer


@pytest.mark.parametrize("cells", [(48, 20), (40, 15), (123, 41)])
def test_compose_pixels_equals_jax(cells):
    got = _backend(pwin, chexel, *cells).compose_pixels()
    want = _backend(jwin, jchexel, *cells).compose_pixels()
    assert got.shape == (cells[1] * 2, cells[0], 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_srgb8_equals_jax():
    c = np.concatenate([np.float32([0.0, 0.0031308, 0.5, 1.0, -1.0, 2.0]),
                        np.random.RandomState(3).rand(500).astype(np.float32)])
    np.testing.assert_array_equal(pwin._srgb8(c), jwin._srgb8(c))


def test_wheel_resize_equals_jax():
    rs = [_backend(m, ch, 120, 40) for m, ch in ((pwin, chexel),
                                                 (jwin, jchexel))]
    for step in [1, 1, -1] + [-1] * 60 + [1] * 120:
        for r in rs:
            r._on_wheel(step)
        assert rs[0].console_size() == rs[1].console_size()
    assert rs[0].console_size() == (pwin.MAX_CELLS_W, pwin.MAX_CELLS_H)


def test_render_headless_dummy_driver():
    r = _backend(pwin, chexel, 40, 15)
    r.scale = 2
    try:
        r.render()
        r.render()
        assert r.frames_rendered == 2
        w, h = r._screen.get_size()
        got = r._screen.get_at((w // 2, h // 2))[:3]
        px = r.compose_pixels()
        want = px[px.shape[0] // 2, px.shape[1] // 2]
        assert np.abs(np.int32(got) - want).max() <= 2  # scale filtering
    finally:
        r.close()
