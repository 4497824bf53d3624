"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small size, with the contracts chip_smoke.py applies at full size.
Marked ``cuda``: they skip where there is no card (run them on the card
with ``python -m pytest --noconftest tests/test_torch_cuda.py``: the
repository conftest imports jax, which the card's machine lacks)."""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (STRESS_H, bit_contract, dda_cases, dda_stress_cases,
                        hit_contract, lbvh_contract, post_contract,
                        record_sweeps, sweep_contract, trace_contract,
                        walk_cases)
from yetanotherconsolegameengine_tpu_torch.config import DEFAULT_CONFIG
from yetanotherconsolegameengine_tpu_torch.core.camera import (
    make_jittered_rays, ray_params)
from yetanotherconsolegameengine_tpu_torch.ops import (cluster_kernel, dda,
                                                       kernels, lbvh,
                                                       mesh_bvh,
                                                       mesh_clusters,
                                                       post_kernel, trace,
                                                       trace_kernel)
from yetanotherconsolegameengine_tpu_torch.ops.intersect import INF
from yetanotherconsolegameengine_tpu_torch.ops.trace import stack_slots
from yetanotherconsolegameengine_tpu_torch.render.renderer import (
    RaytraceRenderer)
from yetanotherconsolegameengine_tpu_torch.scene.builders import SCENE_BUILDERS
from yetanotherconsolegameengine_tpu_torch.scene.mesh_loader import (
    make_icosphere, make_knot)
from yetanotherconsolegameengine_tpu_torch.scene.mesh_scenes import (
    FORCED_SCENE_BUILDERS)
from yetanotherconsolegameengine_tpu_torch.utils import profiling

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


def _post_planes(w, h, seed):
    """Seeded (12, h, w) current and previous G-buffers (~10% sky with INF
    depth, the previous frame moved a little) and a history."""
    rs = np.random.RandomState(seed)

    def gbuf(base=None):
        if base is None:
            sky = rs.uniform(size=(h, w)) < 0.1
            rad = np.exp(rs.normal(-1.5, 1.0, (3, h, w)))
            alb = rs.uniform(0.05, 0.95, (3, h, w))
            n = rs.normal(size=(3, h, w)) + np.float32([0, 2, 0])[:, None, None]
            depth = rs.uniform(1.0, 12.0, (h, w))
        else:
            sky = np.where(rs.uniform(size=(h, w)) < 0.03, base[3] < 0.5,
                           base[3] > 0.5)
            rad = base[0:3] * rs.uniform(0.7, 1.4, (3, h, w))
            alb = base[4:7]
            n = base[7:10] + rs.normal(0.0, 0.15, (3, h, w))
            depth = np.where(base[10] < 1e30, base[10], 5.0) \
                * rs.uniform(0.97, 1.08, (h, w))
        g = np.zeros((12, h, w), np.float32)
        g[0:3], g[4:7], g[3] = rad, alb, sky
        g[7:10] = n / np.linalg.norm(n, axis=0, keepdims=True)
        g[10] = np.where(sky, 3.0e38, depth)
        g[4:10, sky] = 0.0
        return g

    prev = gbuf()
    cur = gbuf(prev)
    hist = (prev[0:3] * rs.uniform(0.8, 1.25, (3, h, w))).astype(np.float32)
    return cur, prev, hist


@pytest.mark.parametrize("case", ["history", "no_history", "reset",
                                  "no_auto_exposure"])
@pytest.mark.parametrize("w,h,fuse_tail,step", [
    (37, 23, True, 2), (160, 180, True, 2), (240, 270, True, 2),
    (320, 360, False, 4), (1280, 720, True, 2)])
def test_post_kernel_sizes_and_flags(dev, w, h, fuse_tail, step, case):
    """The kernel against post_plain at odd sizes (tile and halo edges at
    odd places), the ss=2 frame (no tail, sample step 4) and a frame of
    3,600 tiles, more than one co-resident grid holds."""
    cur, prev, hist = _post_planes(w, h, w + h)
    cfg = DEFAULT_CONFIG
    if case == "no_auto_exposure":
        cfg = dataclasses.replace(cfg, auto_exposure=False)
    t = lambda a: torch.from_numpy(a).to(dev)
    flag = lambda v: torch.tensor(v, dtype=torch.bool, device=dev)
    args = (t(cur), t(prev), t(hist), flag(case != "no_history"),
            flag(case == "reset"), torch.full((), 0.8, device=dev), cfg, step,
            fuse_tail)
    before = kernels.LAUNCHES["post"]
    got = post_kernel.post(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["post"] == before + 1
    ref = post_kernel.post_plain(*args)
    np_ = lambda xs: [None if x is None else x.cpu().numpy() for x in xs]
    post_contract(np_(got), np_(ref))
    if case == "no_auto_exposure":
        assert float(got[3]) == float(np.float32(0.8))


@pytest.mark.parametrize("iterations,clamp_radius", [(4, 1), (5, 1), (3, 77)])
def test_post_kernel_wide_halos_match_plain(dev, iterations, clamp_radius):
    """Phases whose window does not fit in shared memory read their taps
    from global memory: a fifth pass (+-32 halo: 80x80 cells of 48 bytes)
    and a TAA clamp radius of 77 (170x170 cells of 8 bytes); four passes
    stage all of them in 110 KB."""
    cur, prev, hist = _post_planes(70, 45, iterations)
    t = lambda a: torch.from_numpy(a).to(dev)
    cfg = dataclasses.replace(DEFAULT_CONFIG, atrous_iterations=iterations,
                              taa_clamp_radius=clamp_radius)
    args = (t(cur), t(prev), t(hist),
            torch.ones((), dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev),
            torch.full((), 0.8, device=dev), cfg, 2, True)
    got = post_kernel.post(*args)
    torch.cuda.synchronize()
    ref = post_kernel.post_plain(*args)
    np_ = lambda xs: [None if x is None else x.cpu().numpy() for x in xs]
    post_contract(np_(got), np_(ref))


TRACE_SCENES = ("test", "cornell", "mirror_spheres", "primitives", "boxes",
                "glass")


@pytest.mark.parametrize("w,h", [(160, 180), (53, 37)])
@pytest.mark.parametrize("name", TRACE_SCENES)
def test_trace_kernel_matches_plain_on_primitive_scenes(dev, name, w, h):
    """The six texture-free primitive scenes, at the headline size and an
    odd one, under the trace contract."""
    packed = trace_kernel.pack_scene(SCENE_BUILDERS[name]().to(dev))
    params = ray_params(packed.scene.default_pose, w, h, 3)[None]
    frames = torch.tensor([3], dtype=torch.int32, device=dev)
    got = trace_kernel.trace_planes(packed, params.contiguous(), frames, 0, w,
                                    h, DEFAULT_CONFIG)
    torch.cuda.synchronize()
    ref = trace_kernel.trace_planes_plain(packed.scene, params[0], 3, w, h,
                                          DEFAULT_CONFIG)
    trace_contract(got.cpu().numpy(), ref.cpu().numpy())


def test_trace_kernel_deepest_stack(dev):
    """glass with a deep path stack: 15 mirror bounces give
    path_stack_size = 16 slots (90 KB of shared stack for 128 rays)."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, max_mirror_bounces=15)
    assert stack_slots(cfg) == cfg.path_stack_size == 16
    packed = trace_kernel.pack_scene(SCENE_BUILDERS["glass"]().to(dev))
    params = ray_params(packed.scene.default_pose, W, H, 3)[None]
    frames = torch.tensor([3], dtype=torch.int32, device=dev)
    got = trace_kernel.trace_planes(packed, params.contiguous(), frames, 0, W,
                                    H, cfg)
    torch.cuda.synchronize()
    ref = trace_kernel.trace_planes_plain(packed.scene, params[0], 3, W, H,
                                          cfg)
    trace_contract(got.cpu().numpy(), ref.cpu().numpy())


def test_trace_kernel_raises_on_a_table_too_large(dev):
    packed = trace_kernel.pack_scene(SCENE_BUILDERS["cornell"]().to(dev))
    big = dataclasses.replace(packed, table=torch.zeros(60_000, device=dev))
    params = ray_params(packed.scene.default_pose, W, H, 1)[None]
    frames = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="240000 bytes"):
        trace_kernel.trace_planes(big, params.contiguous(), frames, 0, W, H,
                                  DEFAULT_CONFIG)


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


@pytest.mark.parametrize("n", [5, 1280, 3840])
def test_lbvh_on_the_card_equals_the_cpu_build(dev, n):
    """Equal trees (normals within 1e-6) for a straddling leaf, the
    bunny's count and make_knot's."""
    tris = np.concatenate([make_knot(), make_icosphere(3)])[:n]
    soup = [torch.from_numpy(np.ascontiguousarray(x)) for x in
            (tris[:, 0], tris[:, 1], tris[:, 2],
             np.arange(n, dtype=np.int32) % 3)]
    lbvh_contract(lbvh.build_lbvh(*(x.to(dev) for x in soup)),
                  lbvh.build_lbvh(*soup))


def test_scene_to_the_card_rebuilds_its_lbvh_there(dev):
    scene = SCENE_BUILDERS["bunny"]()
    card = scene.to(dev)
    assert card.mesh.bmin.device.type == "cuda"
    lbvh_contract(card.mesh, scene.mesh)


@pytest.mark.parametrize("compact", [True, False])
def test_bvh_walk_on_the_card_equals_the_cpu(dev, compact):
    scene = SCENE_BUILDERS["bunny"]()
    card = scene.to(dev)
    params = ray_params(card.default_pose, W, H, 3)
    o, d = (x.reshape(-1, 3) for x in make_jittered_rays(
        None, W, H, 3, params=params))
    got = mesh_bvh.intersect_mesh(card.mesh, o, d, 1e-3, INF,
                                  compact=compact)
    res = hit_contract(got, mesh_bvh.intersect_mesh(
        scene.mesh, o.cpu(), d.cpu(), 1e-3, INF))
    assert res["hits"] > 50


@pytest.mark.parametrize("name", ["glass_gem", "texture_test"])
def test_renderer_kernels_match_texture_and_gem_goldens(dev, name):
    goldens = np.load("tests/goldens.npz")
    before = kernels.LAUNCHES["post"]
    r = RaytraceRenderer(SCENE_BUILDERS[name](), 48, 28, device=dev)
    assert not isinstance(r.packed, trace_kernel.PackedScene)
    for _ in range(4):
        out = r.render()
    assert kernels.LAUNCHES["post"] == before + 4
    np.testing.assert_allclose(out.top_rgb.cpu().numpy(),
                               goldens[f"{name}_top"], atol=2e-3)
    np.testing.assert_allclose(out.bot_rgb.cpu().numpy(),
                               goldens[f"{name}_bot"], atol=2e-3)


def test_trace_kernel_matches_plain_on_demo_random(dev):
    """74 spheres in a 128-row table fit the kernel and match its plain
    version."""
    scene = SCENE_BUILDERS["demo_random"]()
    assert trace_kernel.scene_fits(scene)
    packed = trace_kernel.pack_scene(scene.to(dev))
    trace_contract(_trace(packed, 3, dev).cpu().numpy(),
                   _trace(packed, 3, dev, plain=True).cpu().numpy())


def _island(dev, tmp_path):
    """The island_surface golden's 2x2x2-chunk island, streamed on the
    card, after one update."""
    from yetanotherconsolegameengine_tpu_torch.world.settings import (
        WorldConfig)
    from yetanotherconsolegameengine_tpu_torch.world.volume_scene import (
        build_minecraft_like)
    vs = build_minecraft_like(
        WorldConfig(chunks_x=2, chunks_y=2, chunks_z=2, view_distance=1),
        world_path=str(tmp_path / "w.vg"), regenerate=True, device=dev)
    try:
        vs.manager.ensure_all_loaded(vs.pos, timeout=60.0)
        scene = vs.update(1.0 / 30.0)
    finally:
        vs.manager.shutdown()
    return dataclasses.replace(scene, defaults=(
        float(vs.pos[0]), float(vs.pos[1]) + 10.0, float(vs.pos[2]),
        scene.defaults[3], -0.9, scene.defaults[5]))


def test_cluster_kernel_matches_plain_on_the_island(dev, tmp_path):
    """Every sweep of an island frame (surface tables with free rows,
    coplanar quads of different blocks sharing edges, any-hit binary
    shadows): nearest winners and t bit-equal to the plain sweep, whose
    ties go to the earlier list entry; any-hit masks equal."""
    scene = _island(dev, tmp_path)
    assert scene.mesh_clusters.gmat.device.type == "cuda"
    r = RaytraceRenderer(scene, W, H, device=dev)
    calls = record_sweeps(r.render)
    assert any(a[5] for a, _ in calls) and not all(a[5] for a, _ in calls)
    for args, got in calls:
        sweep_contract(got, cluster_kernel.trace_tiles_plain(*args), args)


def test_renderer_kernels_on_the_voxel_scenes(dev):
    """voxel_test takes the trace kernel and holds its golden; the DDA
    forms render through the torch DDA and the post kernel, kernel and
    plain renderers equal."""
    from chip_smoke import renderer_contract
    goldens = np.load("tests/goldens.npz")
    kernels.reset_launches()
    r = RaytraceRenderer(SCENE_BUILDERS["voxel_test"](), 48, 28, device=dev)
    for _ in range(4):
        out = r.render()
    assert kernels.LAUNCHES["trace"] == 4
    for half in ("top", "bot"):
        np.testing.assert_allclose(getattr(out, f"{half}_rgb").cpu().numpy(),
                                   goldens[f"voxel_test_{half}"], atol=2e-3)
    from yetanotherconsolegameengine_tpu_torch.scene.voxel_scenes import (
        build_voxel_test_scene)
    for scene in (build_voxel_test_scene(merge="dda"),
                  SCENE_BUILDERS["voxel_cave"]()):
        renderer_contract(scene, 40, 24, dev, frames=2)


@pytest.mark.parametrize("compact", [True, False])
def test_dda_on_the_card_equals_the_cpu(dev, compact):
    from yetanotherconsolegameengine_tpu_torch.ops import dda
    cave = SCENE_BUILDERS["voxel_cave"]()
    params = ray_params(cave.default_pose, 96, 64, 2)
    o, d = (x.reshape(-1, 3) for x in make_jittered_rays(
        None, 96, 64, 2, params=params))
    got = dda.intersect_voxels(cave.voxels.to(dev), o.to(dev), d.to(dev),
                               1e-3, INF, compact=compact)
    res = hit_contract(got, dda.intersect_voxels(cave.voxels, o, d, 1e-3,
                                                 INF))
    assert res["hits"] > 1000 and res["t_bit_equal"] == 1.0


@pytest.mark.parametrize("name", ["exhibit_ring", "spinning_mesh"])
def test_dynamic_scene_at_time_on_the_card_equals_the_cpu(dev, name):
    """DynamicScene.at_time patched on the card (the spinning mesh's LBVH
    rebuilt there) equals the CPU's: tables within 1e-6, leaf order
    equal; the base scene is never written."""
    from chip_smoke import same_dynamic_frame
    cpu = SCENE_BUILDERS[name]()
    card = cpu.to(dev)
    base = card.base.to_numpy()
    for t in (0.0, 1.3, 2.0):
        same_dynamic_frame(card.at_time(t), cpu.at_time(t))
    for k, v in card.base.to_numpy().items():
        assert np.array_equal(v, base[k]), k


def test_scene_setter_on_the_card(dev):
    """``renderer.scene = ...`` on the card: a static scene that fits is
    repacked for K2 and changes the frame; under static=False it stays on
    the wavefront (K1 only) and a dynamic frame renders as the CPU's."""
    r = RaytraceRenderer(SCENE_BUILDERS["cornell"](), 32, 20, device=dev)
    before = r.render().top_rgb.clone()
    r.scene = SCENE_BUILDERS["glass"]()
    assert isinstance(r.packed, trace_kernel.PackedScene)
    kernels.reset_launches()
    after = r.render().top_rgb
    assert kernels.LAUNCHES["trace"] == 1
    assert float((after - before).abs().mean()) > 0.1
    dyn = SCENE_BUILDERS["exhibit_ring"]().to(dev)
    r.set_scene(dyn.at_time(0.0), static=False)
    cpu = RaytraceRenderer(dyn.base, 32, 20, device="cpu")
    cpu.set_scene(dyn.at_time(0.0), static=False)
    kernels.reset_launches()
    for t in (0.1, 0.2):
        r.scene = dyn.at_time(t)
        cpu.scene = dyn.at_time(t)
        got, want = r.render(), cpu.render()
    assert kernels.LAUNCHES["trace"] == 0 and kernels.LAUNCHES["post"] == 2
    np.testing.assert_allclose(got.top_rgb.cpu().numpy(),
                               want.top_rgb.numpy(), atol=2e-3)


def test_program_headless_on_the_card(dev):
    """The terminal program on the card (its default device), ANSI to a
    temporary file: frames, HUD, both kernels and the native encoder."""
    from chip_smoke import run_program
    from yetanotherconsolegameengine_tpu_torch import native
    for batch in ("1", "3"):
        kernels.reset_launches()
        rc, data, _ = run_program(["--scene", "cornell", "--frames", "6",
                                   "--size", "40x20", "--no-world",
                                   "--non-interactive", "--batch", batch])
        assert rc == 0
        assert b"\x1b[38;5;" in data and "▀".encode() in data
        assert b"fps" in data
        assert kernels.LAUNCHES["trace"] > 0 and kernels.LAUNCHES["post"] > 0
    assert native.load() is not None


# ---- row bands (parallel/sharding.py) -----------------------------------
@pytest.mark.parametrize("name", ["cornell", "glass"])
def test_trace_kernel_band_is_bit_equal_to_the_full_frame(dev, name):
    """K2 on the bands of 2 and 4 ranks, and on an odd band, is those rows
    of the full-frame K2 bit for bit."""
    packed = trace_kernel.pack_scene(SCENE_BUILDERS[name]().to(dev))
    params = ray_params(packed.scene.default_pose, W, H, 3)[None]
    frames = torch.tensor([3], dtype=torch.int32, device=dev)
    full = trace_kernel.trace_planes(packed, params.contiguous(), frames, 0,
                                     W, H, DEFAULT_CONFIG)
    bands = [(r * H // n, (r + 1) * H // n) for n in (2, 4) for r in range(n)]
    for rows in bands + [(5, 17)]:
        band = trace_kernel.trace_planes(packed, params.contiguous(), frames,
                                         0, W, H, DEFAULT_CONFIG, rows)
        torch.cuda.synchronize()
        assert torch.equal(band, full[:, rows[0]:rows[1]]), rows


@pytest.mark.parametrize("fuse_tail,step", [(True, 2), (False, 4)])
@pytest.mark.parametrize("world", [2, 6])
def test_post_band_kernel_matches_plain_band(dev, world, fuse_tail, step):
    """K1's band mode, launch A on each extended band and launch B on the
    combined partial, against the plain band mode within the post
    contract; two launches a band."""
    w, h = 70, 60
    cur, prev, hist = (torch.from_numpy(a).to(dev)
                       for a in _post_planes(w, h, world))
    cfg = DEFAULT_CONFIG
    halo = post_kernel.halo_rows(cfg)
    flags = (torch.ones((), dtype=torch.bool, device=dev),
             torch.zeros((), dtype=torch.bool, device=dev))
    ae = torch.full((), 0.8, device=dev)
    band_h = h // world
    got, ref = [], []
    before = kernels.LAUNCHES["post"]
    for r in range(world):
        y0, y1 = r * band_h, (r + 1) * band_h
        e0, e1 = max(0, y0 - halo), min(h, y1 + halo)
        ext = [x[:, e0:e1].contiguous() for x in (cur, prev, hist)]
        got.append(post_kernel.post_band(*ext, *flags, cfg, step, e0,
                                         (y0 - e0, y1 - e0)))
        ref.append(post_kernel.post_band_plain(*ext, *flags, cfg, step, e0,
                                               (y0 - e0, y1 - e0)))
    total = post_kernel.combine_partials(torch.stack([g[2] for g in got]))
    want_total = post_kernel.combine_partials(torch.stack([x[2] for x in ref]))
    assert float(total[1]) == float(want_total[1])
    assert abs(float(total[0]) - float(want_total[0])) <= 1e-3
    tails = [post_kernel.post_band_tail(g[1], total, ae, cfg, fuse_tail)
             for g in got]
    want_tails = [post_kernel.post_band_tail_plain(x[1], total, ae, cfg,
                                                   fuse_tail) for x in ref]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["post"] == before + 2 * world
    cat = lambda xs, k: (None if xs[0][k] is None else
                         torch.cat([x[k] for x in xs], dim=-2).cpu().numpy())
    post_contract([cat(got, 0), cat(tails, 0), cat(tails, 1),
                   tails[0][2].cpu().numpy()],
                  [cat(ref, 0), cat(want_tails, 0), cat(want_tails, 1),
                   want_tails[0][2].cpu().numpy()])
    assert all(float(t[2]) == float(tails[0][2]) for t in tails)


def test_sharded_frames_on_the_card_match_the_unsharded_frame(dev):
    """Two ranks sharing the card over gloo (host-staged exchange), Cornell
    at 48x28, 4 frames, against the kernel renderer: top within 2e-5, fg
    equal; each rank launched K2 and K1."""
    from yetanotherconsolegameengine_tpu_torch.parallel import sharding
    res = sharding.spawn(2, sharding.frames_job, [sharding.FrameJob(
        "cornell", SCENE_BUILDERS["cornell"], 48, 28, n_frames=4)],
        device="cuda", backend="gloo")
    r = RaytraceRenderer(SCENE_BUILDERS["cornell"](), 48, 28, device=dev)
    for _ in range(4):
        out = r.render()
    got = res[0]["frames"]["cornell"]
    np.testing.assert_allclose(got["top_rgb"], out.top_rgb.cpu().numpy(),
                               atol=2e-5)
    np.testing.assert_array_equal(got["fg_ansi"], out.fg_ansi.cpu().numpy())
    for rank in res:
        assert rank["launches"]["cornell"]["trace"] == 4
        assert rank["launches"]["cornell"]["post"] == 8


def test_ss2_frame_on_the_kernels_matches_plain(dev):
    """mirror_spheres at 240x135 cells with ss=2 (480x540 traced pixels,
    the post's tail in torch on the averaged cells): kernel vs plain
    renderer over 4 frames, both kernels launched every frame."""
    from chip_smoke import renderer_contract
    kernels.reset_launches()
    renderer_contract(SCENE_BUILDERS["mirror_spheres"](), 240, 135, dev,
                      ss=2)
    assert kernels.LAUNCHES["trace"] == 4 and kernels.LAUNCHES["post"] == 4


def test_trace_kernel_matches_plain_with_ten_lights(dev):
    """A room of 10 lights (the JAX megakernel takes 8) fits the trace
    kernel, which matches its plain version; so do the renderers."""
    from chip_smoke import many_lights_scene, renderer_contract
    from yetanotherconsolegameengine_tpu_torch.scene.materials import (
        Material)
    from yetanotherconsolegameengine_tpu_torch.scene.tables import (
        SceneBuilder)
    scene = many_lights_scene(SceneBuilder, Material)
    assert int(scene.lights.mask.sum()) == 10
    assert trace_kernel.scene_fits(scene)
    packed = trace_kernel.pack_scene(scene.to(dev))
    before = kernels.LAUNCHES["trace"]
    got = _trace(packed, 3, dev)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["trace"] == before + 1
    trace_contract(got.cpu().numpy(),
                   _trace(packed, 3, dev, plain=True).cpu().numpy())
    renderer_contract(scene, 48, 28, dev, frames=2)


def test_world_one_nccl_frames_equal_the_gloo_frames(dev, tmp_path):
    """``make_group``'s default on the card (NCCL, the exchange on the
    card, nothing staged) at world 1: Cornell and cluster_forced at 48x28
    over 4 frames bit-equal to the same frames over gloo, K2/K3 and K1
    launched; a scene of every dtype round-trips through
    ``broadcast_scene``; ``combine`` returns the band's own partial."""
    from chip_smoke import (combine_check, every_dtype_scene, post_inputs,
                            scene_round_trip, world1_run)
    from yetanotherconsolegameengine_tpu_torch.parallel import sharding
    from yetanotherconsolegameengine_tpu_torch.world.volume_scene import (
        build_minecraft_like)
    from yetanotherconsolegameengine_tpu_torch.world.settings import (
        WorldConfig)
    vs = build_minecraft_like(
        cfg=WorldConfig(chunks_x=2, chunks_y=1, chunks_z=2, chunk_size=16,
                        view_distance=1, seed=42),
        world_path=str(tmp_path / "w.vg"), device=dev)
    try:
        island = vs.update(1 / 30)
    finally:
        vs.manager.shutdown()
    inputs = post_inputs(trace_kernel.pack_scene(
        SCENE_BUILDERS["cornell"]().to(dev)), 48, 56, dev)
    jobs = [sharding.FrameJob("cornell", SCENE_BUILDERS["cornell"], 48, 28,
                              n_frames=4),
            sharding.FrameJob("cluster_forced",
                              FORCED_SCENE_BUILDERS["cluster_forced"], 48,
                              28, n_frames=4)]
    gloo = world1_run("gloo", jobs, DEFAULT_CONFIG)
    nccl = world1_run(None, jobs, DEFAULT_CONFIG, lambda g: (
        scene_round_trip(g, every_dtype_scene(island, dev)),
        combine_check(g, inputs, DEFAULT_CONFIG)))
    assert nccl["group"] == {"backend": "nccl", "exchange": str(dev),
                             "staged": False}
    for name, frame in nccl["frames"].items():
        for k, a in frame.items():
            np.testing.assert_array_equal(a, gloo["frames"][name][k])
    assert nccl["launches"]["cornell"]["trace"] == 4
    assert nccl["launches"]["cluster_forced"]["clusters"] > 0
    assert all(c["post"] == 8 for c in nccl["launches"].values())
    assert {"bool", "float32", "int16", "int32"} <= set(
        nccl["extra"][0]["dtypes"])


_CASES = {}


def _sweep_cases(dev, which):
    """Phase 11's and 15's inputs at 96x64 rays, with the DDA's stress
    grid at 4,608 rays (one build a process)."""
    if which not in _CASES:
        _CASES[which] = (walk_cases(dev, 96, 64) if which == "walk" else
                         {**dda_cases(dev, 96, 64),
                          **dda_stress_cases(dev, 4608)})
    return _CASES[which]


def _first(case, P):
    """A sweep case cut to its first ``P`` rays."""
    grid, o, d, lo, hi = case
    cut = [x[:P] if torch.is_tensor(x) else x for x in (lo, hi)]
    return (grid, o[:P].contiguous(), d[:P].contiguous(), *cut)


@pytest.mark.parametrize("P", [0, 1, 7, 31, 4097])
@pytest.mark.parametrize("name", ["bunny_primary", "bunny_bounce",
                                  "knot_lbvh", "large_lbvh",
                                  "exhibit_ring_primary"])
def test_walk_kernel_equals_the_plain_walk_bit_for_bit(dev, name, P):
    """One launch a sweep (none for an empty batch), t, n, u, v, mat and
    hit bit-equal to the plain walk on the card. 7 rays leave the last
    lane group of their warp without a ray; the large LBVH's 8,191
    headers overflow the staging budget, so its tail is read through L1."""
    args = _first(_sweep_cases(dev, "walk")[name], P)
    before = kernels.LAUNCHES["bvh"]
    got = mesh_bvh.intersect_mesh(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bvh"] == before + (1 if P else 0)
    res = bit_contract(got, mesh_bvh.intersect_mesh(*args, impl="plain"))
    assert res["rays"] == P


@pytest.mark.parametrize("P", [0, 1, 31, 4097])
@pytest.mark.parametrize("name", ["voxel_cave_primary", "voxel_cave_bounce",
                                  "voxel_test_dda",
                                  *(f"stress_h{h}" for h in STRESS_H)])
def test_dda_kernel_equals_the_plain_loop_bit_for_bit(dev, name, P):
    """One launch a sweep (none for an empty batch), t, n, u, v, mat and
    hit bit-equal to the plain loop on the card: on phase 15's rays and on
    the stress grid (grazing runs of jump-0 rounds, jumps, exits, per-ray
    tmax), at voxel sizes with an exact reciprocal (1, 0.5, 2) and without
    (0.3)."""
    args = _first(_sweep_cases(dev, "dda")[name], P)
    before = kernels.LAUNCHES["dda"]
    got = dda.intersect_voxels(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dda"] == before + (1 if P else 0)
    res = bit_contract(got, dda.intersect_voxels(*args, impl="plain"))
    assert res["rays"] == P


@pytest.mark.parametrize("tree", ["twins", "one_leaf"])
def test_walk_kernel_ties_and_the_inf_corner(dev, tree):
    """Bit-equal to the plain walk where the lane group's reduction decides:
    every triangle twice in its leaf (equal t: the first twin wins), and a
    tree that is one leaf under a tmax of inf (a ray that misses takes INF
    there with triangle 0's data)."""
    knot = make_knot(seg_u=40, seg_v=6)
    a, b, c = (knot[:, i] for i in range(3))
    if tree == "twins":
        a, b, c = (np.repeat(x, 2, axis=0) for x in (a, b, c))
    else:
        a, b, c = a[:3], b[:3], c[:3]
    bvh = mesh_bvh.build_mesh_bvh(a, b, c, np.arange(len(a), dtype=np.int32))
    rs = np.random.RandomState(3)
    cent = (a + b + c) / 3
    o = rs.randn(2048, 3) * (3.0 if tree == "twins" else 1.0)
    d = cent[rs.randint(0, len(cent), 2048)] + 0.05 * rs.randn(2048, 3) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.from_numpy(x.astype(np.float32)).to(dev) for x in (o, d))
    tmax = INF if tree == "twins" else float("inf")
    card = bvh.to(dev)
    got = mesh_bvh.intersect_mesh(card, o, d, 1e-3, tmax)
    want = mesh_bvh.intersect_mesh(card, o, d, 1e-3, tmax, impl="plain")
    res = bit_contract(got, want)
    if tree == "twins":
        assert res["hits"] > 100
        assert (want.mat[want.hit] % 2 == 0).all()
    else:
        assert card.n_nodes == 1
        assert 0 < int((want.t == INF).sum()) < 2048


def test_walk_kernel_stages_every_header_that_fits(dev):
    """The launch shape on the card: every header of a tree that fits in the
    staging budget staged, the first that fit of the large LBVH's; the grid
    at most SMs x resident blocks."""
    props = torch.cuda.get_device_properties(dev)
    for name, (bvh, o, *_) in _sweep_cases(dev, "walk").items():
        shape = mesh_bvh.walk_shape(bvh.n_nodes, o.shape[0], dev)
        assert shape["sms"] == props.multi_processor_count
        assert shape["n_shared"] == mesh_bvh.shared_nodes(bvh.n_nodes,
                                                          shape["budget"])
        assert shape["blocks_per_sm"] >= 1
        assert shape["blocks"] == mesh_bvh.grid_blocks(
            o.shape[0], shape["sms"], shape["blocks_per_sm"],
            32 // shape["lanes"])
        assert (shape["n_shared"] < bvh.n_nodes) == (name == "large_lbvh")


def test_walk_launch_refused_for_shared_memory_raises(dev):
    """A launch that asks for more shared memory than a block may have is
    refused before it runs, and the wrapper's check raises."""
    bvh, o, d, lo, hi = _first(_sweep_cases(dev, "walk")["large_lbvh"], 64)
    optin = mesh_bvh._limits(kernels.library(), dev.index, 0)[0]
    out = [torch.empty(n, device=dev) for n in (64, 192, 64, 64)]
    out += [torch.empty(64, dtype=torch.int32, device=dev),
            torch.empty(64, dtype=torch.bool, device=dev)]
    lo, hi = torch.full((64,), 1e-3, device=dev), torch.full((64,), INF,
                                                            device=dev)
    err = kernels.library().yacge_bvh_launch(
        bvh.heads.data_ptr(), bvh.tris.data_ptr(), bvh.n_nodes,
        optin // 32 + 1, 1, o.data_ptr(), d.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), 64, *(x.data_ptr() for x in out),
        torch.cuda.current_stream(dev).cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels.check(err, "BVH walk kernel")
    # The refusal leaves nothing behind: the next sweep launches and agrees.
    got = mesh_bvh.intersect_mesh(bvh, o, d, lo, hi)
    bit_contract(got, mesh_bvh.intersect_mesh(bvh, o, d, lo, hi,
                                              impl="plain"))


def test_walk_and_dda_kernels_reject_bad_inputs(dev):
    """The wrappers take contiguous f32 (int16 cells) CUDA tensors only."""
    bvh, o, d, _, _ = _first(_sweep_cases(dev, "walk")["knot_lbvh"], 64)
    w, vo, vd, _, _ = _first(_sweep_cases(dev, "dda")["voxel_cave_primary"],
                             64)
    lo = torch.full((64,), 1e-3, device=dev)
    hi = torch.full((64,), INF, device=dev)
    wide = torch.zeros((64, 6), device=dev)[:, :3]
    heads, tris = bvh.heads, bvh.tris

    def off16(x):
        return torch.empty(x.numel() + 1, device=dev)[1:].view_as(x)
    for call, bad in (
            (lambda x: mesh_bvh.walk(heads, tris, x, d, lo, hi),
             [(o.cpu(), ValueError), (o.double(), TypeError),
              (wide, ValueError)]),
            (lambda x: mesh_bvh.walk(x, tris, o, d, lo, hi),
             [(heads.cpu(), ValueError), (heads[:, :7], ValueError),
              (heads[:, :7].contiguous(), ValueError), (bvh.rows, ValueError),
              (off16(heads), ValueError)]),
            (lambda x: mesh_bvh.walk(heads, x, o, d, lo, hi),
             [(tris.cpu(), ValueError), (tris[1:], ValueError),
              (tris[..., :13].contiguous(), ValueError),
              (tris.transpose(0, 1), ValueError), (off16(tris), ValueError)]),
            (lambda x: dda.march(w.cells, w.origin, w.voxel_size, x, vd, lo,
                                 hi),
             [(vo.cpu(), ValueError), (vo.double(), TypeError),
              (wide, ValueError)]),
            (lambda x: dda.march(x, w.origin, w.voxel_size, vo, vd, lo, hi),
             [(w.cells.cpu(), ValueError), (w.cells.int(), TypeError),
              (w.cells.transpose(0, 2), ValueError)])):
        for x, err in bad:
            with pytest.raises(err):
                call(x)


def _wavefront_frames(dev, scene, n=4, reassign=False):
    """``n`` frames of ``scene`` at 40x23 cells through the renderer, the
    camera turning a little each frame: each frame's G-buffer, outputs,
    state and counts (``reassign``: the scene assigned anew every frame)."""
    r = RaytraceRenderer(scene, 40, 23, device=dev)
    assert isinstance(r.packed, type(r.scene))      # the wavefront
    frames = []
    for k in range(n):
        if reassign:
            r.scene = scene
        r.set_camera(r.cam_pos, r.yaw + 0.05 * k, r.pitch)
        kernels.reset_launches()
        out = r.render()
        torch.cuda.synchronize()
        planes = {f.name: getattr(out, f.name).clone()
                  for f in dataclasses.fields(out)}
        planes.update(gbuf=r.state.prev_gbuf.clone(),
                      history=r.state.history.clone(),
                      exposure=r.state.ae_exposure.clone())
        counts = (kernels.LAUNCHES["bvh"], kernels.LAUNCHES["dda"],
                  mesh_bvh.STATS["sweeps"],
                  profiling.COUNTS["wavefront.shadow_sweeps"],
                  profiling.SYNCS["trace.round_live"],
                  profiling.SYNCS["trace.shadow_live"])
        graphs = tuple(profiling.COUNTS[f"wavefront.{c}"] for c in
                       ("graph_captures", "graph_replays", "eager_segments"))
        frames.append((planes, counts, graphs))
    trace._GRAPHS = None
    return frames


@pytest.mark.parametrize("name", ["museum", "bunny", "teapot", "glass_gem",
                                  "texture_test", "voxel_cave"])
def test_wavefront_graphs_replay_the_eager_frames_bit_for_bit(dev, name,
                                                              monkeypatch):
    """From the second frame of a scene on, the wavefront replays CUDA
    graphs: every plane equal to the eager frame's, and per frame the same
    walk and DDA launches, sweeps, shadow sweeps and live checks."""
    scene = SCENE_BUILDERS[name]()
    monkeypatch.setattr(trace, "WAVEFRONT_GRAPHS", False)
    eager = _wavefront_frames(dev, scene)
    monkeypatch.setattr(trace, "WAVEFRONT_GRAPHS", True)
    graphed = _wavefront_frames(dev, scene)
    for k, ((want, want_n, off), (got, got_n, _)) in enumerate(
            zip(eager, graphed)):
        for key, x in want.items():
            assert torch.equal(x, got[key]), (k, key)
        assert want_n == got_n, k
        assert off[:2] == (0, 0) and off[2] > 0
    kinds = [g for _, _, g in graphed]
    assert kinds[0][:2] == (0, 0)               # the first frame: eager
    assert kinds[1][0] >= 4                     # captures, from the second
    for captures, replays, eager_segments in kinds[2:]:
        assert (captures, eager_segments) == (0, 0) and replays > 0


@pytest.mark.parametrize("case", ["cluster_forced", "reassigned"])
def test_wavefront_graphs_stay_off_where_shapes_or_scene_change(dev, case):
    """A cluster-mesh scene (its wavefront compacts) and a scene assigned
    anew every frame run eagerly."""
    if case == "cluster_forced":
        frames = _wavefront_frames(dev, FORCED_SCENE_BUILDERS[case]())
    else:
        frames = _wavefront_frames(dev, SCENE_BUILDERS["bunny"](),
                                   reassign=True)
    for _, _, (captures, replays, eager) in frames:
        assert (captures, replays) == (0, 0) and eager > 0
