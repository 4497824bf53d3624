"""The port's trace (the plain version of the trace kernel) against the JAX
package: the Pallas megakernel run in interpret mode, and the XLA
wavefront ``trace_all``, both held to the contract of
tests/test_pallas_trace.py:49-74 (chip_smoke.trace_contract) at its shapes
(48x32, frame 3)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import many_lights_scene, trace_contract
from yetanotherconsolegameengine_tpu.config import DEFAULT_CONFIG as JCFG
from yetanotherconsolegameengine_tpu.core import sampler as jsampler
from yetanotherconsolegameengine_tpu.core.camera import make_jittered_rays
from yetanotherconsolegameengine_tpu.ops import trace as jtrace
from yetanotherconsolegameengine_tpu.ops.pallas_trace import (
    snapshot_scene, trace_all_pallas)
from yetanotherconsolegameengine_tpu.scene import builders as jbuilders
from yetanotherconsolegameengine_tpu.scene import materials as jmaterials
from yetanotherconsolegameengine_tpu.scene import tables as jtables
from yetanotherconsolegameengine_tpu_torch.config import DEFAULT_CONFIG
from yetanotherconsolegameengine_tpu_torch.core import u64
from yetanotherconsolegameengine_tpu_torch.core.camera import ray_params
from yetanotherconsolegameengine_tpu_torch.ops import trace, trace_kernel
from yetanotherconsolegameengine_tpu_torch.scene import (builders, materials,
                                                        tables)

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

W, H = 48, 32
FRAME = 3


def _planes(res) -> np.ndarray:
    """A TraceResult (either package) as (12, H, W) planes. The JAX result
    has no per-lane ray counts, so its total goes into pixel (0, 0)."""
    lane = getattr(res, "lane_rays", None)
    if lane is None:
        lane = np.zeros(H * W, np.float32)
        lane[0] = int(res.rays_traced)
    cols = [np.asarray(res.radiance),
            np.asarray(res.is_sky, np.float32)[:, None],
            np.asarray(res.albedo), np.asarray(res.normal),
            np.asarray(res.depth)[:, None],
            np.asarray(lane, np.float32)[:, None]]
    return np.concatenate(cols, axis=1).T.reshape(12, H, W)


def test_plain_trace_kernel_matches_pallas_megakernel():
    jsc = jbuilders.SCENE_BUILDERS["cornell"]()
    want = trace_all_pallas(jsc, snapshot_scene(jsc), jsc.default_pose,
                            jnp.asarray(FRAME, jnp.int32), W, H, JCFG,
                            interpret=True)
    psc = builders.SCENE_BUILDERS["cornell"]()
    got = trace_kernel.trace_planes_plain(
        psc, ray_params(psc.default_pose, W, H, FRAME), FRAME, W, H,
        DEFAULT_CONFIG)
    trace_contract(got.numpy(), _planes(want))


def _scenes(name):
    """(JAX scene, port scene) of a builder's name, or of "many_lights":
    ``chip_smoke.many_lights_scene``'s room of 10 lights, which the JAX
    package traces on its wavefront (the megakernel takes 8) and the port
    on its trace kernel."""
    if name == "many_lights":
        return (many_lights_scene(jtables.SceneBuilder, jmaterials.Material),
                many_lights_scene(tables.SceneBuilder, materials.Material))
    return jbuilders.SCENE_BUILDERS[name](), builders.SCENE_BUILDERS[name]()


@pytest.mark.parametrize("name,binary", [("cornell", False), ("glass", False),
                                         ("mirror_spheres", False),
                                         ("glass", True),
                                         ("many_lights", False)])
def test_trace_all_matches_xla_wavefront(name, binary):
    jsc, psc = (dataclasses.replace(sc, binary_shadows=binary)
                for sc in _scenes(name))
    o, d = make_jittered_rays(jsc.default_pose, W, H,
                              jnp.asarray(FRAME, jnp.int32))
    px = jnp.broadcast_to(jnp.arange(W, dtype=jnp.uint32)[None], (H, W))
    py = jnp.broadcast_to(jnp.arange(H, dtype=jnp.uint32)[:, None], (H, W))
    seed = jsampler.per_frame_seed(px, py, jnp.asarray(FRAME, jnp.int32),
                                   JCFG.seed_salt)
    want = jtrace.trace_all(jsc, o.reshape(-1, 3), d.reshape(-1, 3),
                            (seed[0].reshape(-1), seed[1].reshape(-1)), JCFG)
    # The same rays and seeds, carried across as numpy.
    hi = np.asarray(seed[0]).astype(np.int64).reshape(-1)
    lo = np.asarray(seed[1]).astype(np.int64).reshape(-1)
    rng = torch.from_numpy((hi << 32) | lo)
    assert (u64.hi32(rng).numpy() == hi).all()
    got = trace.trace_all(psc,
                          torch.from_numpy(np.array(o).reshape(-1, 3)),
                          torch.from_numpy(np.array(d).reshape(-1, 3)),
                          rng, DEFAULT_CONFIG)
    assert int(got.rays_traced) == int(want.rays_traced)
    trace_contract(_planes(got), _planes(want))
    if name == "many_lights":
        assert int(psc.lights.mask.sum()) == 10
        assert trace_kernel.scene_fits(psc, DEFAULT_CONFIG)


def test_stack_clamp_is_exact(monkeypatch):
    """The clamped path stack gives the same planes as the full one on a
    transparency-heavy scene with raised bounce caps."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, max_mirror_bounces=4,
                              max_refractions=4)
    sc = builders.SCENE_BUILDERS["glass"]()
    params = ray_params(sc.default_pose, W, H, FRAME)
    clamped = trace_kernel.trace_planes_plain(sc, params, FRAME, W, H, cfg)
    monkeypatch.setattr(trace, "STACK_CLAMP", False)
    full = trace_kernel.trace_planes_plain(sc, params, FRAME, W, H, cfg)
    np.testing.assert_array_equal(clamped.numpy(), full.numpy())
