"""The port's video mode against the JAX package's: the Lanczos-3
matrices and aspect fit exactly, and ``VideoRenderer`` on synthetic frames
(RGB within 1e-5, ANSI indices equal)."""

import numpy as np
import pytest
import torch

from yetanotherconsolegameengine_tpu.video import renderer as jvideo
from yetanotherconsolegameengine_tpu_torch.video import renderer as pvideo
from yetanotherconsolegameengine_tpu_torch.video.readers import (
    SyntheticReader)

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)


class _Frames:
    """A reader that hands out the given frames, then nothing."""

    def __init__(self, *frames):
        self.frames = list(frames)

    def try_get_frame(self):
        return self.frames.pop(0) if self.frames else None


@pytest.mark.parametrize("src,dst", [(320, 80), (100, 240), (64, 64),
                                     (54, 28)])
def test_lanczos_weights_equal_jax(src, dst):
    np.testing.assert_array_equal(pvideo._lanczos_weights(src, dst),
                                  jvideo._lanczos_weights(src, dst))


@pytest.mark.parametrize("args", [(1920, 1080, 400, 100),
                                  (1920, 1080, 100, 400), (96, 54, 40, 40)])
def test_fit_rect_equals_jax(args):
    assert pvideo._fit_rect(*args) == jvideo._fit_rect(*args)


@pytest.mark.parametrize("src_wh,fb_wh,ss", [((96, 54), (40, 20), 1),
                                             ((64, 48), (24, 14), 2),
                                             ((30, 90), (20, 10), 1)])
def test_video_renderer_equals_jax(src_wh, fb_wh, ss):
    """One seeded frame through both renderers: top/bottom RGB within
    1e-5, both ANSI grids equal."""
    w, h = src_wh
    rs = np.random.RandomState(w * h)
    frame = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    frame[: h // 3] = SyntheticReader(width=w, height=h).try_get_frame()[
        : h // 3]
    got = pvideo.VideoRenderer(_Frames(frame), *fb_wh, ss=ss,
                               device="cpu").render()
    want = jvideo.VideoRenderer(_Frames(frame), *fb_wh, ss=ss).render()
    for k in (0, 1):
        assert got[k].shape == (fb_wh[1], fb_wh[0], 3)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5)
    for k in (2, 3):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got[0].std() > 0.05


def test_video_renderer_keeps_the_last_frame():
    vr = pvideo.VideoRenderer(_Frames(np.zeros((8, 8, 3), np.uint8)), 4, 2,
                              device="cpu")
    first = vr.render()
    assert vr.render() is first
    assert pvideo.VideoRenderer(_Frames(), 4, 2, device="cpu").render() \
        is None


def test_video_renderer_wants_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pvideo.VideoRenderer(_Frames(), 4, 2)
