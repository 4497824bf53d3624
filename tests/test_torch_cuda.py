"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small size, with the contracts chip_smoke.py applies at full size.
Marked ``cuda``: they skip where there is no card (run them on the card
with ``python -m pytest --noconftest tests/test_torch_cuda.py``: the
repository conftest imports jax, which the card's machine lacks)."""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (post_contract, record_sweeps, sweep_contract,
                        trace_contract)
from yetanotherconsolegameengine_tpu_torch.config import DEFAULT_CONFIG
from yetanotherconsolegameengine_tpu_torch.core.camera import ray_params
from yetanotherconsolegameengine_tpu_torch.ops import (cluster_kernel, kernels,
                                                       mesh_clusters,
                                                       post_kernel,
                                                       trace_kernel)
from yetanotherconsolegameengine_tpu_torch.render.renderer import (
    RaytraceRenderer)
from yetanotherconsolegameengine_tpu_torch.scene.builders import SCENE_BUILDERS
from yetanotherconsolegameengine_tpu_torch.scene.mesh_loader import (
    make_icosphere)
from yetanotherconsolegameengine_tpu_torch.scene.mesh_scenes import (
    FORCED_SCENE_BUILDERS)

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda
W, H = 48, 32


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _trace(packed, frame, dev, plain=False):
    params = ray_params(packed.scene.default_pose, W, H, frame)[None]
    frames = torch.tensor([frame], dtype=torch.int32, device=dev)
    if plain:
        return trace_kernel.trace_planes_plain(packed.scene, params[0], frame,
                                               W, H, DEFAULT_CONFIG)
    return trace_kernel.trace_planes(packed, params.contiguous(), frames, 0,
                                     W, H, DEFAULT_CONFIG)


@pytest.mark.parametrize("name,binary", [
    ("cornell", False), ("glass", False), ("mirror_spheres", False),
    ("primitives", False), ("glass", True)])
def test_trace_kernel_matches_plain(dev, name, binary):
    scene = dataclasses.replace(SCENE_BUILDERS[name](), binary_shadows=binary)
    packed = trace_kernel.pack_scene(scene.to(dev))
    before = kernels.LAUNCHES["trace"]
    got = _trace(packed, 3, dev)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["trace"] == before + 1
    trace_contract(got.cpu().numpy(),
                   _trace(packed, 3, dev, plain=True).cpu().numpy())


@pytest.mark.parametrize("fuse_tail", [True, False])
def test_post_kernel_matches_plain(dev, fuse_tail):
    packed = trace_kernel.pack_scene(SCENE_BUILDERS["cornell"]().to(dev))
    cur, prev = _trace(packed, 3, dev), _trace(packed, 2, dev)
    hist = cur[0:3] * 1.1
    args = (cur, prev, hist.contiguous(),
            torch.ones((), dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev),
            torch.full((), 0.8, device=dev), DEFAULT_CONFIG, 2, fuse_tail)
    got = post_kernel.post(*args)
    torch.cuda.synchronize()
    ref = post_kernel.post_plain(*args)
    np_ = lambda xs: [None if x is None else x.cpu().numpy() for x in xs]
    post_contract(np_(got), np_(ref))


def test_renderer_kernels_match_goldens(dev):
    goldens = np.load("tests/goldens.npz")
    r = RaytraceRenderer(SCENE_BUILDERS["cornell"](), 48, 28, device=dev)
    for _ in range(4):
        out = r.render()
    np.testing.assert_allclose(out.top_rgb.cpu().numpy(),
                               goldens["cornell_top"], atol=2e-3)
    np.testing.assert_allclose(out.bot_rgb.cpu().numpy(),
                               goldens["cornell_bot"], atol=2e-3)


def test_kernel_rejects_bad_inputs(dev):
    packed = trace_kernel.pack_scene(SCENE_BUILDERS["cornell"]().to(dev))
    params = ray_params(packed.scene.default_pose, W, H, 1)[None]
    with pytest.raises(TypeError):
        trace_kernel.trace_planes(packed, params.contiguous(),
                                  torch.ones(1, device=dev), 0, W, H,
                                  DEFAULT_CONFIG)
    with pytest.raises(IndexError):
        trace_kernel.trace_planes(
            packed, params.contiguous(),
            torch.ones(1, dtype=torch.int32, device=dev), 1, W, H,
            DEFAULT_CONFIG)


def _cluster_case(kc, dev, n=5000):
    """A sphere and a small one beside it, and rays half aimed at them."""
    tris = np.concatenate([make_icosphere(4) * 1.3, make_icosphere(2) * 0.4
                           + np.float32([0.9, 0.9, 0.0])])
    mats = (np.arange(len(tris)) % 5).astype(np.int32)
    mc = mesh_clusters.build_clusters(tris[:, 0], tris[:, 1], tris[:, 2],
                                      mats, kc=kc).to(dev)
    rng = np.random.RandomState(kc)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[: n // 2] = (rng.uniform(-2.5, 2.5, (n // 2, 3)) * np.float32([1, 1, 0])
                   + np.float32([0, 0, 3.5]))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2] = -o[: n // 2] + rng.normal(scale=0.3, size=(n // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return mc, torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


@pytest.mark.parametrize("kc", [256, 512])
@pytest.mark.parametrize("any_hit", [False, True])
def test_cluster_kernel_matches_plain(dev, kc, any_hit):
    """Nearest mode: t and winners bit-equal to the plain sweep, and so the
    whole hit; any-hit mode: equal hit masks, every winner a real
    blocker."""
    mc, o, d = _cluster_case(kc, dev)
    before = kernels.LAUNCHES["clusters"]
    kw = dict(any_hit=any_hit)
    calls = record_sweeps(lambda: mesh_clusters.intersect_clusters(
        mc, o, d, 1e-3, 3e38, impl="kernel", **kw))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["clusters"] == before + 1
    (args, got), = calls
    res = sweep_contract(got, cluster_kernel.trace_tiles_plain(*args), args)
    assert res["hits"] > 500
    hk = mesh_clusters.intersect_clusters(mc, o, d, 1e-3, 3e38,
                                          impl="kernel", **kw)
    hp = mesh_clusters.intersect_clusters(mc, o, d, 1e-3, 3e38,
                                          impl="plain", **kw)
    for k in (("hit",) if any_hit else ("hit", "t", "mat", "n", "u", "v")):
        assert torch.equal(getattr(hk, k), getattr(hp, k)), k


def _sweep_args(kc, dev, n_live=256, n_entries=None, seed=0):
    """One tile of K3 inputs: ``n_live`` of its 256 rays take part, and its
    list holds ``n_entries`` clusters (all by default) in near-to-far
    order of their entry distance along the tile's mean direction."""
    tris = np.concatenate([make_icosphere(5) * 1.3, make_icosphere(4) * 0.5
                           + np.float32([1.2, 0.6, -0.8])])
    mc = mesh_clusters.build_clusters(tris[:, 0], tris[:, 1], tris[:, 2],
                                      np.zeros(len(tris), np.int32), kc=kc)
    rng = np.random.RandomState(seed)
    o = np.tile(np.float32([[0.1, 0.2, 4.0]]), (256, 1))
    d = np.concatenate([rng.uniform(-0.4, 0.4, (256, 2)),
                        -np.ones((256, 1))], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tinit = np.full(256, 3.0e37, np.float32)
    tinit[rng.permutation(256)[n_live:]] = -np.inf
    rays = np.concatenate([o, d, np.full((256, 1), 1e-3, np.float32),
                           tinit[:, None]], 1).astype(np.float32)
    C = mc.n_clusters
    # Entry distances: the nearest point of each cluster box from the
    # shared origin, a conservative lower bound on every triangle's t.
    near = np.clip(o[0], mc.cbmin.numpy(), mc.cbmax.numpy())
    entry = np.linalg.norm(near - o[0], axis=1).astype(np.float32) * 0.999
    order = np.argsort(entry, kind="stable")
    n = C if n_entries is None else n_entries
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return (t(np.int32([n])), t(order[None].astype(np.int32)),
            t(entry[order][None]), mc.gmat.to(dev), t(rays))


@pytest.mark.parametrize("kc,n_live,any_hit", [
    (256, 256, False), (256, 16, False), (512, 256, False), (512, 16, False),
    (256, 16, True), (512, 256, True)])
def test_cluster_kernel_long_list_and_few_live_rays(dev, kc, n_live, any_hit):
    """One tile whose list holds every cluster (at least 48 entries), with
    all 256 or only 16 live rays, at kc 256 and 512."""
    args = _sweep_args(kc, dev, n_live) + (any_hit, 2047 if kc == 512
                                          else 1023)
    assert int(args[0][0]) >= 48
    before = kernels.LAUNCHES["clusters"]
    got = cluster_kernel.trace_tiles(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["clusters"] == before + 1
    res = sweep_contract(got, cluster_kernel.trace_tiles_plain(*args), args)
    assert res["hits"] >= n_live // 2
    assert int((got[1] >= 0).sum()) <= n_live


def test_cluster_kernel_rejects_bad_inputs(dev):
    mc, o, d = _cluster_case(256, dev, n=512)
    (args, _), = record_sweeps(lambda: mesh_clusters.intersect_clusters(
        mc, o, d, 1e-3, 3e38, impl="kernel"))
    bad = list(args)
    bad[3] = args[3].double()
    with pytest.raises(TypeError):
        cluster_kernel.trace_tiles(*bad)
    bad[3] = args[3].cpu()
    with pytest.raises(ValueError):
        cluster_kernel.trace_tiles(*bad)


@pytest.mark.parametrize("name", sorted(FORCED_SCENE_BUILDERS))
def test_renderer_kernels_match_cluster_goldens(dev, name):
    goldens = np.load("tests/goldens.npz")
    before = kernels.LAUNCHES["clusters"]
    r = RaytraceRenderer(FORCED_SCENE_BUILDERS[name](), 48, 28, device=dev)
    for _ in range(4):
        out = r.render()
    assert kernels.LAUNCHES["clusters"] > before
    np.testing.assert_allclose(out.top_rgb.cpu().numpy(),
                               goldens[f"{name}_top"], atol=2e-3)
    np.testing.assert_allclose(out.bot_rgb.cpu().numpy(),
                               goldens[f"{name}_bot"], atol=2e-3)
