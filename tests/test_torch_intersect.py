"""The port's primitive intersectors against the JAX package's, per type,
on random rays: t and normal within 1e-5 where hit, equal material ids
and hit masks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yetanotherconsolegameengine_tpu.ops import intersect as jintersect
from yetanotherconsolegameengine_tpu.scene import builders as jbuilders
from yetanotherconsolegameengine_tpu_torch.ops import intersect
from yetanotherconsolegameengine_tpu_torch.scene import builders

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

# A scene per table that holds rows of that type.
CASES = [("spheres", "glass"), ("boxes", "boxes"), ("rects", "cornell"),
         ("cylinders", "primitives"), ("disks", "primitives"),
         ("planes", "primitives"), ("triangles", "primitives")]


def _rays(seed, n=2048):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    o[:, 1] = rs.uniform(0.05, 4.0, n)
    o[:, 2] = rs.uniform(-4.0, 2.0, n)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = rs.uniform(1.0, 30.0, n).astype(np.float32)
    return o, d, tmin, tmax


def _compare(want, got):
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert hit.sum() > 20
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.n.numpy()[hit], np.asarray(want.n)[hit],
                               atol=1e-5)
    np.testing.assert_array_equal(got.mat.numpy()[hit],
                                  np.asarray(want.mat)[hit])


@pytest.mark.parametrize("table,scene", CASES)
def test_intersector_matches_jax(table, scene):
    jsc = jbuilders.SCENE_BUILDERS[scene]()
    psc = builders.SCENE_BUILDERS[scene]()
    o, d, tmin, tmax = _rays(sum(map(ord, table)))
    want = getattr(jintersect, f"intersect_{table}")(
        getattr(jsc, table), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax))
    got = getattr(intersect, f"intersect_{table}")(
        getattr(psc, table), torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(tmin), torch.from_numpy(tmax))
    _compare(want, got)


@pytest.mark.parametrize("scene", ["cornell", "primitives", "glass"])
def test_intersect_scene_matches_jax(scene):
    jsc = jbuilders.SCENE_BUILDERS[scene]()
    psc = builders.SCENE_BUILDERS[scene]()
    o, d, _, _ = _rays(7)
    want = jintersect.intersect_scene(jsc, jnp.asarray(o), jnp.asarray(d),
                                      1e-3, jintersect.INF)
    got = intersect.intersect_scene(psc, torch.from_numpy(o),
                                    torch.from_numpy(d), 1e-3, intersect.INF)
    _compare(want, got)


@pytest.mark.parametrize("v", [1e-3, 1e-4, intersect.INF, 2.9e30, 0.1, -7.3])
def test_col_fills_a_bound_as_the_host_copy_gave_it(v):
    """A Python bound is filled on the device with the float32 that a copy
    from the host gave, as a (P, 1) column, and waits on nothing; a tensor
    bound is as before."""
    from yetanotherconsolegameengine_tpu_torch.utils import profiling
    o = torch.zeros((5, 3))
    profiling.reset()
    for bound in (v, v * torch.tensor([1.0, 0.5, 0.25, 2.0 ** -20, 0.0])):
        got = intersect._col(bound, o)
        want = torch.as_tensor(bound, dtype=torch.float32).expand(5)[:, None]
        assert (got.dtype, got.shape) == (want.dtype, want.shape)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not profiling.SYNCS
