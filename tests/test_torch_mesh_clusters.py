"""The port's cluster traversal (plain sweep) against the JAX package's
``intersect_clusters`` (its Pallas kernel in interpret mode, as
tests/test_mesh_clusters.py runs it), and ``trace_tiles_plain`` against a
brute-force nearest hit.

Contract against JAX: equal hit masks and materials, t and u, v within
1e-5 (relative for t), normals within 1e-5 — on every ray whose winner is
unambiguous. Where two triangles of a shared edge both pass the 1e-3
barycentric slack within 1e-3 relative t, the two packages may pick either
(the JAX kernel's t carries bf16-split matmul error and its key quantum
ties differently across clusters); there the hits must agree and t within
1e-3 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yetanotherconsolegameengine_tpu.ops import mesh_clusters as jmc
from yetanotherconsolegameengine_tpu.scene.mesh_loader import make_icosphere
from yetanotherconsolegameengine_tpu_torch.ops import cluster_kernel
from yetanotherconsolegameengine_tpu_torch.ops import mesh_clusters as pmc

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

INF = 3.0e38


def _mesh():
    """tests/test_mesh_clusters.py's mesh: a sphere and a small knot."""
    tris = make_icosphere(2) * 1.3
    knot = make_icosphere(1) * 0.4 + np.asarray([0.9, 0.9, 0.0], np.float32)
    tris = np.concatenate([tris, knot])
    mat = (np.arange(len(tris)) % 5).astype(np.int32)
    return tris, mat


def _rays(n=2048, seed=0):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[: n // 2] = rng.uniform(-2.5, 2.5, size=(n // 2, 3)) * np.asarray(
        [1, 1, 0], np.float32) + np.asarray([0, 0, 3.5], np.float32)
    d[: n // 2] = -o[: n // 2] + rng.normal(scale=0.3, size=(n // 2, 3))
    d[: n // 2] /= np.linalg.norm(d[: n // 2], axis=1, keepdims=True)
    return o, d


def _candidates(tris, o, d, tmin, tmax):
    """(P, N) float64 t of every triangle a ray passes within the 1e-3
    barycentric slack (inf elsewhere)."""
    a = tris[:, 0].astype(np.float64)
    e1 = tris[:, 1] - a
    e2 = tris[:, 2] - a
    o = o.astype(np.float64)[:, None]
    d = d.astype(np.float64)[:, None]
    h = np.cross(d, e2[None])
    det = np.sum(e1[None] * h, -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / det
        s = o - a[None]
        u = np.sum(s * h, -1) * inv
        q = np.cross(s, e1[None])
        v = np.sum(d * q, -1) * inv
        t = np.sum(e2[None] * q, -1) * inv
    ok = ((u >= -1e-3) & (v >= -1e-3) & (1 - u - v >= -1e-3)
          & (t > np.asarray(tmin)[..., None])
          & (t < np.asarray(tmax)[..., None]) & np.isfinite(t))
    return np.where(ok, t, np.inf)


def _ambiguous(cand):
    """Rays whose two nearest candidates lie within 1e-3 relative t."""
    two = np.sort(cand, axis=1)[:, :2]
    with np.errstate(invalid="ignore"):
        close = two[:, 1] - two[:, 0] <= 1e-3 * np.abs(two[:, 0])
    return np.isfinite(two[:, 1]) & close


def _port(mc, o, d, tmin, tmax, **kw):
    return pmc.intersect_clusters(mc, torch.from_numpy(o),
                                  torch.from_numpy(d), tmin, tmax, **kw)


def _jax(mc, o, d, tmin, tmax, **kw):
    return jmc.intersect_clusters(mc, jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(tmin), jnp.asarray(tmax),
                                  interpret=True, **kw)


def _hold(got, want, d, amb, any_hit=False):
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.mat.numpy()[hit],
                                  np.asarray(want.mat)[hit])
    t_g, t_w = got.t.numpy(), np.asarray(want.t)
    if any_hit:
        # Some blocking hit: both kernels stop at their own exit votes.
        np.testing.assert_array_equal(got.n.numpy(), -d)
        return
    clear = hit & ~amb
    assert clear.sum() > 0.9 * hit.sum()
    np.testing.assert_allclose(t_g[clear], t_w[clear], rtol=1e-5, atol=0)
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy()[clear],
                                   np.asarray(getattr(want, k))[clear],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.n.numpy()[clear],
                               np.asarray(want.n)[clear], atol=1e-5)
    tied = hit & amb
    np.testing.assert_allclose(t_g[tied], t_w[tied], rtol=1e-3)


@pytest.mark.parametrize("kc,any_hit,presort", [
    (256, False, True), (256, False, False), (512, False, True),
    (256, True, True), (512, True, False)])
def test_intersect_clusters_matches_jax(kc, any_hit, presort):
    tris, mat = _mesh()
    jm = jmc.build_clusters(tris[:, 0], tris[:, 1], tris[:, 2], mat, kc=kc)
    pm = pmc.build_clusters(tris[:, 0], tris[:, 1], tris[:, 2], mat, kc=kc)
    o, d = _rays(2048, seed=3)
    tmin = np.full(len(o), 1e-3, np.float32)
    tmax = np.full(len(o), INF, np.float32)
    want = _jax(jm, o, d, tmin, tmax, any_hit=any_hit, presort=presort)
    got = _port(pm, o, d, tmin, tmax, any_hit=any_hit, presort=presort)
    assert got.hit.sum() > 500
    _hold(got, want, d, _ambiguous(_candidates(tris, o, d, tmin, tmax)),
          any_hit)


def test_per_ray_tmin_tmax_and_inactive_rays_match_jax():
    """Marching a per-ray tmin past the first hit finds the far side
    (strict t > tmin, tests/test_mesh_clusters.py:162); a per-ray tmax and
    far-away (inactive) origins are honoured as in the JAX package."""
    tris, mat = _mesh()
    jm = jmc.build_clusters(tris[:, 0], tris[:, 1], tris[:, 2], mat)
    pm = pmc.build_clusters(tris[:, 0], tris[:, 1], tris[:, 2], mat)
    n = 512
    o = np.tile(np.float32([[0.0, 0.0, 3.0]]), (n, 1))
    ang = np.linspace(-0.25, 0.25, n, dtype=np.float32)
    d = np.stack([np.sin(ang), 0.1 * np.cos(3 * ang), -np.cos(ang)], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o[::7] = 2.9e30                                      # inactive lanes
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, INF, np.float32)
    h1 = _port(pm, o, d, tmin, tmax)
    assert not h1.hit.numpy()[::7].any() and h1.hit.numpy().mean() > 0.8
    tmin2 = np.where(h1.hit.numpy(), h1.t.numpy() + 1e-3, 1e-3)
    tmin2 = tmin2.astype(np.float32)
    tmax2 = np.where(np.arange(n) % 5 == 0, 3.0, INF).astype(np.float32)
    for tlo, thi in ((tmin, tmax), (tmin2, tmax), (tmin2, tmax2)):
        want = _jax(jm, o, d, tlo, thi)
        got = _port(pm, o, d, tlo, thi)
        _hold(got, want, d, _ambiguous(_candidates(tris, o, d, tlo, thi)))
    h2 = _port(pm, o, d, tmin2, tmax)
    both = h1.hit.numpy() & h2.hit.numpy()
    assert both.mean() > 0.75
    assert (h2.t.numpy()[both] > h1.t.numpy()[both]).all()


def _wall(z, n=256):
    tris = []
    g = int(np.ceil(np.sqrt(n / 2)))
    for i in range(g):
        for j in range(g):
            x0, y0 = -2 + 4 * i / g, -2 + 4 * j / g
            x1, y1 = -2 + 4 * (i + 1) / g, -2 + 4 * (j + 1) / g
            tris.append(((x0, y0, z), (x1, y0, z), (x1, y1, z)))
            tris.append(((x0, y0, z), (x1, y1, z), (x0, y1, z)))
    return np.asarray(tris[:n], np.float32)


def test_early_exit_skips_the_occluded_cluster():
    """A near wall that occludes every ray of the tile: the far wall's
    cluster is in the list (the rays reach it inside the mesh bounds) but
    never visited; steps count entries, not the TPU kernel's loop steps."""
    tris = np.concatenate([_wall(-1.0), _wall(-100.0)])
    mc = pmc.build_clusters(tris[:, 0], tris[:, 1], tris[:, 2],
                            np.zeros(len(tris), np.int32))
    P = 256
    o = np.zeros((P, 3), np.float32)
    o[:, 2] = 1.0
    rng = np.random.RandomState(0)
    d = np.stack([rng.uniform(-0.01, 0.01, P), rng.uniform(-0.01, 0.01, P),
                  -np.ones(P)], -1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    h, (steps, lens) = _port(mc, o, d, 1e-3, INF, stats=True)
    assert bool(h.hit.all())
    np.testing.assert_allclose(h.t.numpy(), 2.0, atol=0.3)
    assert int(lens[0]) == 2 and int(steps[0]) == 1


def _sweep_inputs(kc, seed, n_tiles=3):
    """Tiles of random rays through a small mesh, every cluster listed
    once per tile in random order with entry distance 0 (no exit)."""
    tris, mat = _mesh()
    mc = pmc.build_clusters(tris[:, 0], tris[:, 1], tris[:, 2], mat, kc=kc)
    o, d = _rays(n_tiles * 256, seed)
    rng = np.random.RandomState(seed)
    tmin = rng.uniform(1e-3, 1.0, len(o)).astype(np.float32)
    tinit = np.where(rng.uniform(size=len(o)) < 0.1, -np.inf,
                     rng.uniform(2.0, 8.0, len(o))).astype(np.float32)
    rays = np.concatenate([o, d, tmin[:, None], tinit[:, None]], 1)
    C = mc.n_clusters
    ids = np.stack([rng.permutation(C) for _ in range(n_tiles)])
    lens = np.full(n_tiles, C, np.int32)
    entry = np.zeros((n_tiles, C), np.float32)
    t = torch.from_numpy
    return (mc, t(lens), t(ids.astype(np.int32)), t(entry),
            t(np.ascontiguousarray(rays.astype(np.float32))))


def _brute(mc, rays, qmask, ids):
    """Nearest hit over every triangle with the kernel's float32 Woop
    arithmetic and winner rule: min (key(t), list position, slot), the
    triangles taken in the order of each ray's tile list ``ids`` (every
    cluster listed)."""
    g = mc.gmat.numpy()                                  # (C, 12, kc)
    C, _, kc = g.shape
    rows = g.transpose(1, 0, 2).reshape(12, C * kc)[:, None, :]
    order = ids.numpy()[np.arange(rays.shape[0]) // 256]          # (P, C)
    flat_of = (order[:, :, None] * kc + np.arange(kc)).reshape(len(order),
                                                               -1)
    r = rays.numpy()
    ox, oy, oz, dx, dy, dz = (r[:, i, None] for i in range(6))
    tmin, tinit = r[:, 6, None], r[:, 7]
    with np.errstate(divide="ignore", invalid="ignore"):
        ou = ((rows[0] * ox + rows[1] * oy) + rows[2] * oz) + rows[3]
        du = (rows[0] * dx + rows[1] * dy) + rows[2] * dz
        ov = ((rows[4] * ox + rows[5] * oy) + rows[6] * oz) + rows[7]
        dv = (rows[4] * dx + rows[5] * dy) + rows[6] * dz
        ow = ((rows[8] * ox + rows[9] * oy) + rows[10] * oz) + rows[11]
        dw = (rows[8] * dx + rows[9] * dy) + rows[10] * dz
        t = -ow / dw
        u = ou + t * du
        v = ov + t * dv
        ok = ((u >= np.float32(-1e-3)) & (v >= np.float32(-1e-3))
              & ((1 - u) - v >= np.float32(-1e-3)) & (t > tmin))
    key = (t.view(np.int32) & ~qmask).view(np.float32)
    key = np.take_along_axis(np.where(ok, key, np.inf), flat_of, 1)
    kmin = key.min(1)
    lanes = np.arange(len(r))
    flat = flat_of[lanes, np.argmax(key == kmin[:, None], axis=1)]
    init = (tinit.view(np.int32) & ~qmask).view(np.float32)
    hit = np.isfinite(kmin) & (kmin < init)
    return (np.where(hit, t[lanes, flat], 3.0e38),
            np.where(hit, flat, -1))


@pytest.mark.parametrize("kc,qmask", [(256, 0), (256, 1023), (512, 2047)])
def test_trace_tiles_plain_matches_brute_force(kc, qmask):
    """Random list orders give the brute-force winner of (key(t), list
    position, slot), t bit-equal."""
    mc, lens, ids, entry, rays = _sweep_inputs(kc, seed=kc + qmask)
    want_t, want_id = _brute(mc, rays, qmask, ids)
    t, win, steps = cluster_kernel.trace_tiles_plain(
        lens, ids, entry, mc.gmat, rays, False, qmask)
    assert (want_id >= 0).sum() > 100
    np.testing.assert_array_equal(win.numpy(), want_id)
    np.testing.assert_array_equal(t.numpy(), want_t.astype(np.float32))
    np.testing.assert_array_equal(steps.numpy(), lens.numpy())
    # The wrapper takes the plain version for CPU tensors.
    again = cluster_kernel.trace_tiles(lens, ids, entry, mc.gmat, rays,
                                       False, qmask)
    np.testing.assert_array_equal(again[1].numpy(), want_id)


def test_exit_cadence_does_not_change_nearest_hits(monkeypatch):
    """In nearest mode the early exit (a vote before every list entry) is
    exact: the sweep inside ``intersect_clusters`` skips entries, and its
    winners equal the brute-force nearest hit over every triangle for the
    same binned rays, t bit-equal."""
    tris = make_icosphere(4) * 1.3          # 20 clusters
    mc = pmc.build_clusters(tris[:, 0], tris[:, 1], tris[:, 2],
                            np.zeros(len(tris), np.int32))
    rng = np.random.RandomState(5)
    n = 512
    o = np.tile(np.float32([[0.0, 0.0, 3.0]]), (n, 1))
    aim = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)), np.zeros((n, 1))],
                         1)
    d = aim - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    seen = []
    real = cluster_kernel.trace_tiles_plain
    monkeypatch.setattr(cluster_kernel, "trace_tiles_plain",
                        lambda *a: seen.append((a, real(*a))) or seen[-1][1])
    h = _port(mc, o, d, 1e-3, INF)
    assert len(seen) == 1 and bool(h.hit.all())
    (lens, ids, _, _, rays, any_hit, qmask), (t, win, steps) = seen[0]
    assert not any_hit
    want_t, want_id = _brute(mc, rays, qmask, ids)
    assert (want_id >= 0).sum() >= n
    np.testing.assert_array_equal(win.numpy(), want_id)
    np.testing.assert_array_equal(t.numpy(), want_t.astype(np.float32))
    assert (steps <= lens).all() and steps.sum() < lens.sum()
