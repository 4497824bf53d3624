"""The port's core (u64, sampler, camera, config) against the JAX package:
integer results bit-exact, float results within 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yetanotherconsolegameengine_tpu import config as jconfig
from yetanotherconsolegameengine_tpu.core import camera as jcamera
from yetanotherconsolegameengine_tpu.core import sampler as jsampler
from yetanotherconsolegameengine_tpu.core import u64 as ju64
from yetanotherconsolegameengine_tpu_torch import config as pconfig
from yetanotherconsolegameengine_tpu_torch.core import camera, sampler, u64

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

M64 = (1 << 64) - 1


def splitmix64_ref(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return z ^ (z >> 31)


def _u64_tensor(vals):
    return torch.tensor([u64.to_i64(v) for v in vals], dtype=torch.int64)


def _unsigned(t):
    return [int(v) & M64 for v in t.tolist()]


def _jax_pair(t):
    """A port u64 tensor as the JAX package's (hi, lo) uint32 pair."""
    return (jnp.asarray(u64.hi32(t).numpy().astype(np.uint32)),
            jnp.asarray(u64.lo32(t).numpy().astype(np.uint32)))


def _assert_pair_equal(t, pair):
    np.testing.assert_array_equal(u64.hi32(t).numpy(),
                                  np.asarray(pair[0]).astype(np.int64))
    np.testing.assert_array_equal(u64.lo32(t).numpy(),
                                  np.asarray(pair[1]).astype(np.int64))


def test_splitmix64_matches_python_and_jax():
    rs = np.random.RandomState(0)
    vals = [0, 1, 1 << 63, M64, 0x9E3779B97F4A7C15] + [
        int(v) for v in rs.randint(0, 1 << 62, 1000, dtype=np.int64)]
    t = _u64_tensor(vals)
    got = u64.splitmix64(t)
    assert _unsigned(got) == [splitmix64_ref(v) for v in vals]
    _assert_pair_equal(got, ju64.splitmix64(_jax_pair(t)))


@pytest.mark.parametrize("k", [1, 13, 31, 32, 40, 63])
def test_logical_shift(k):
    vals = [0, 1, 1 << 63, M64, 0xDEADBEEFCAFEF00D]
    got = _unsigned(u64.shr(_u64_tensor(vals), k))
    assert got == [v >> k for v in vals]


def test_per_frame_seed_bit_exact():
    rs = np.random.RandomState(1)
    px = rs.randint(0, 4096, 512)
    py = rs.randint(0, 4096, 512)
    for frame in (0, 3, 0x7FFFFFFF):
        got = sampler.per_frame_seed(torch.from_numpy(px),
                                     torch.from_numpy(py), frame,
                                     pconfig.DEFAULT_CONFIG.seed_salt)
        want = jsampler.per_frame_seed(
            jnp.asarray(px, jnp.uint32), jnp.asarray(py, jnp.uint32),
            jnp.asarray(frame, jnp.int32), jconfig.DEFAULT_CONFIG.seed_salt)
        _assert_pair_equal(got, want)


def test_bayer_base_and_rng_unit():
    py, px = np.mgrid[0:16, 0:16]
    got = sampler.bayer_base(torch.from_numpy(px), torch.from_numpy(py))
    want = jsampler.bayer_base(jnp.asarray(px), jnp.asarray(py))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Every Bayer value appears once per 8x8 tile.
    assert sorted((got.numpy()[:8, :8] * 64 - 0.5).astype(int).ravel()
                  .tolist()) == list(range(64))
    seed = sampler.per_frame_seed(torch.arange(256), torch.arange(256) * 7,
                                  5, 0x9E3779B97F4A7C15)
    state, x = sampler.rng_next_unit(seed)
    jstate, jx = jsampler.rng_next_unit(_jax_pair(seed))
    _assert_pair_equal(state, jstate)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))


def test_cosine_sample_hemisphere():
    rs = np.random.RandomState(2)
    n = rs.normal(size=(512, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[0] = (0.0, 0.0, -1.0)          # the degenerate basis branch
    seed = sampler.per_frame_seed(torch.arange(512), torch.zeros(512,
                                  dtype=torch.int64), 1, 12345)
    st, d = sampler.cosine_sample_hemisphere(torch.from_numpy(n), seed)
    jst, jd = jsampler.cosine_sample_hemisphere(jnp.asarray(n),
                                                _jax_pair(seed))
    _assert_pair_equal(st, jst)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)


@pytest.mark.parametrize("pose", [((0.0, 1.0, 3.0), 0.0, 0.0, 60.0),
                                  ((1.5, 2.0, -0.5), 0.7, -0.3, 75.0)])
def test_ray_params_and_jittered_rays(pose):
    pos, yaw, pitch, fov = pose
    jcam = jcamera.CameraPose.create(pos, yaw, pitch, fov)
    pcam = camera.CameraPose.create(pos, yaw, pitch, fov, device="cpu")
    for frame in (1, 3, 1000):
        want = np.asarray(jcamera.ray_params(jcam, 48, 32, frame))
        got = camera.ray_params(pcam, 48, 32, frame)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        _, jd = jcamera.make_jittered_rays(jcam, 48, 32,
                                           jnp.asarray(frame, jnp.int32))
        o, d = camera.make_jittered_rays(pcam, 48, 32, frame)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
        np.testing.assert_array_equal(o.numpy(),
                                      np.broadcast_to(pos, (32, 48, 3))
                                      .astype(np.float32))
    # Batched over frames: one (N, 18) call equals N single calls.
    frames = torch.tensor([1, 2, 3], dtype=torch.int32)
    batch = camera.CameraPose.create([pos] * 3, [yaw] * 3, [pitch] * 3,
                                     [fov] * 3, device="cpu")
    rows = camera.ray_params(batch, 48, 32, frames)
    for i, f in enumerate((1, 2, 3)):
        np.testing.assert_array_equal(
            rows[i].numpy(), camera.ray_params(pcam, 48, 32, f).numpy())


def test_config_defaults_match_the_jax_config():
    jdef = jconfig.DEFAULT_CONFIG
    for f in dataclasses.fields(pconfig.RenderConfig):
        assert getattr(pconfig.DEFAULT_CONFIG, f.name) == getattr(jdef, f.name), \
            f.name
