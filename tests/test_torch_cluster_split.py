"""The split schedule of the cluster kernel (K3), held on the CPU through
its plain pieces: the packed 64-bit winner word, pieces of a tile's list
combined in any order, the epilogue's t, and the any-hit hit masks.

The kernel cuts each tile's list into pieces that run in parallel and
combines them with atomicMin on one word per ray; these tests run
``trace_tiles_plain`` on each piece, combine the words (``pack_words``) in
shuffled orders and read them back as the epilogue does (``unpack_words``).
Sweeps come from random cases and from the CPU frames of the
``cluster_forced`` / ``fine_forced`` scenes."""

import numpy as np
import pytest
import torch

from chip_smoke import k3_work, real_blockers, sweep_contract
from yetanotherconsolegameengine_tpu_torch.ops import cluster_kernel as ck
from yetanotherconsolegameengine_tpu_torch.ops import mesh_clusters as pmc
from yetanotherconsolegameengine_tpu_torch.render.renderer import (
    RaytraceRenderer)
from yetanotherconsolegameengine_tpu_torch.scene.mesh_loader import (
    make_icosphere)
from yetanotherconsolegameengine_tpu_torch.scene.mesh_scenes import (
    FORCED_SCENE_BUILDERS)

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("qmask", [0, 1023, 2047])
def test_packed_word_orders_as_key_then_flat_id(qmask):
    """Word order is (key(t), list index) order, ties and -0 == +0
    included, and a ray's starting word is beaten only by a strictly
    smaller key."""
    rng = np.random.RandomState(qmask)
    n = 4000
    t = np.concatenate([
        rng.uniform(-5, 5, n // 4), rng.uniform(0, 1e-3, n // 4),
        np.repeat(rng.uniform(0.5, 2.0, n // 40), 10),   # exact ties
        1.0 + rng.randint(0, 4096, n // 4) * np.float32(2 ** -23),
        [0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40]]).astype(np.float32)
    flat = rng.randint(0, 1 << 20, t.size).astype(np.int32)
    rays = torch.zeros(t.size, 8)
    w = ck.pack_words(torch.from_numpy(t), torch.from_numpy(flat), rays,
                      qmask).numpy()
    key = ck.key_of(torch.from_numpy(t), qmask).numpy().astype(np.float64)
    i, j = rng.randint(0, t.size, (2, 200_000))
    want = (key[i] < key[j]) | ((key[i] == key[j]) & (flat[i] < flat[j]))
    np.testing.assert_array_equal(w[i] < w[j], want)
    np.testing.assert_array_equal(w[i] == w[j],
                                  (key[i] == key[j]) & (flat[i] == flat[j]))
    # The starting word: key(tinit) with id 0; no hit yet (win -1).
    tinit = torch.from_numpy(rng.permutation(t))
    rays[:, 7] = tinit
    start = ck.pack_words(tinit, _no_hit(t.size), rays, qmask).numpy()
    kinit = ck.key_of(tinit, qmask).numpy().astype(np.float64)
    np.testing.assert_array_equal(w < start, key < kinit)


def _rand_sweep(kc, seed, n_tiles=3):
    """Tiles of random rays through a sphere and a knot, every cluster
    listed once per tile in random order with random entry distances below
    every hit (no exit)."""
    tris = np.concatenate([make_icosphere(3) * 1.3, make_icosphere(2) * 0.4
                           + np.float32([0.9, 0.9, 0.0])])
    mc = pmc.build_clusters(tris[:, 0], tris[:, 1], tris[:, 2],
                            np.zeros(len(tris), np.int32), kc=kc)
    rng = np.random.RandomState(seed)
    P = n_tiles * 256
    o = rng.uniform(-3, 3, (P, 3)).astype(np.float32)
    o[: P // 2] = (rng.uniform(-2.5, 2.5, (P // 2, 3)) * np.float32([1, 1, 0])
                   + np.float32([0, 0, 3.5]))
    d = rng.normal(size=(P, 3)).astype(np.float32)
    d[: P // 2] = -o[: P // 2] + rng.normal(scale=0.3, size=(P // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = rng.uniform(1e-3, 0.5, P).astype(np.float32)
    tinit = np.where(rng.uniform(size=P) < 0.1, -np.inf,
                     rng.uniform(2.0, 8.0, P)).astype(np.float32)
    rays = np.concatenate([o, d, tmin[:, None], tinit[:, None]], 1)
    C = mc.n_clusters
    ids = np.stack([rng.permutation(C) for _ in range(n_tiles)])
    lens = rng.randint(C // 2, C + 1, n_tiles).astype(np.int32)
    entry = np.sort(rng.uniform(0.0, 1e-3, (n_tiles, C)), 1)
    t = torch.from_numpy
    return (t(lens), t(ids.astype(np.int32)), t(entry.astype(np.float32)),
            mc.gmat, t(np.ascontiguousarray(rays.astype(np.float32))))


def _frame_sweeps(name):
    """Every sweep of one small CPU frame of a forced cluster scene."""
    calls = []
    real = ck.trace_tiles_plain

    def spy(*args):
        calls.append(args)
        return real(*args)

    ck.trace_tiles_plain = spy
    try:
        RaytraceRenderer(FORCED_SCENE_BUILDERS[name](), 16, 8,
                         device="cpu").render()
    finally:
        ck.trace_tiles_plain = real
    return calls


def _list_index(ids, win, kc, e0=0):
    """Flat winners -> their list indices e * kc + k in the rays' tile
    lists ``ids`` (which start at list position ``e0``); -1 stays."""
    tile = torch.arange(win.shape[0]) // 256
    e = (ids[tile] == (win // kc)[:, None]).to(torch.int32).argmax(1)
    return torch.where(win >= 0, (e0 + e) * kc + win % kc,
                       -1).to(torch.int32)


def _split(args, piece, order_seed):
    """The kernel's schedule on the plain version: each piece of ``piece``
    entries of every tile's list swept on its own, the words combined by
    minimum in a shuffled order, read back by the epilogue."""
    lens, ids, entry_t, gmat, rays, any_hit, qmask = args
    C, kc = ids.shape[1], gmat.shape[2]
    words = []
    for e0 in range(0, C, piece):
        sl = slice(e0, min(C, e0 + piece))
        plen = torch.clamp(lens - e0, 0, piece).to(torch.int32)
        t, win, _ = ck.trace_tiles_plain(
            plen, ids[:, sl].contiguous(), entry_t[:, sl].contiguous(), gmat,
            rays, any_hit, qmask)
        idx = _list_index(ids[:, sl], win, kc, e0)
        words.append(ck.pack_words(t, idx, rays, qmask))
    best = ck.pack_words(rays[:, 7], _no_hit(rays.shape[0]), rays, qmask)
    for i in np.random.RandomState(order_seed).permutation(len(words)):
        best = torch.minimum(best, words[i])
    return ck.unpack_words(best, ids, gmat, rays, qmask)


def _brute(args):
    """Nearest (key(t), list index) over each tile's listed triangles, with
    the sweep's float32 arithmetic."""
    lens, ids, _, gmat, rays, _, qmask = args
    kc = gmat.shape[2]
    out_t, out_w = [], []
    for tile in range(ids.shape[0]):
        cid = ids[tile, : int(lens[tile])].long()
        g = gmat[cid].permute(1, 0, 2).reshape(12, -1)[:, None, :]
        idx = torch.arange(cid.numel() * kc)
        r = rays[tile * 256:(tile + 1) * 256]
        ox, oy, oz, dx, dy, dz = (r[:, i, None] for i in range(6))
        ou = ((g[0] * ox + g[1] * oy) + g[2] * oz) + g[3]
        du = (g[0] * dx + g[1] * dy) + g[2] * dz
        ov = ((g[4] * ox + g[5] * oy) + g[6] * oz) + g[7]
        dv = (g[4] * dx + g[5] * dy) + g[6] * dz
        ow = ((g[8] * ox + g[9] * oy) + g[10] * oz) + g[11]
        dw = (g[8] * dx + g[9] * dy) + g[10] * dz
        t = -ow / dw
        u = ou + t * du
        v = ov + t * dv
        ok = ((u >= -1e-3) & (v >= -1e-3) & ((1.0 - u) - v >= -1e-3)
              & (t > r[:, 6, None]))
        start = ck.pack_words(r[:, 7], _no_hit(256), r, qmask)
        best = start
        if idx.numel():
            words = ck.pack_words(
                t.reshape(-1),
                torch.where(ok, idx.to(torch.int32), -1).reshape(-1),
                r[:, None, :].expand(-1, idx.numel(), -1).reshape(-1, 8),
                qmask).reshape(256, -1)
            best = torch.minimum(words.amin(1), start)
        tt, ww = ck.unpack_words(best, ids[tile:tile + 1], gmat, r, qmask)
        out_t.append(tt)
        out_w.append(ww)
    return torch.cat(out_t), torch.cat(out_w)


def _no_hit(n):
    return torch.full((n,), -1, dtype=torch.int32)


_CASES = [("random", 256, 0), ("random", 512, 2047), ("cluster_forced",),
          ("fine_forced",)]


def _sweeps(case):
    if case[0] == "random":
        _, kc, qmask = case
        return [_rand_sweep(kc, kc + qmask) + (any_hit, qmask)
                for any_hit in (False, True)]
    return _frame_sweeps(case[0])


@pytest.mark.parametrize("case", _CASES, ids=lambda c: "-".join(map(str, c)))
def test_split_schedule_matches_whole_list_in_any_order(case):
    """Pieces of 1 and 3 entries, combined in two shuffled orders: nearest
    mode gives t and winners bit-equal to the whole-list call and to the
    brute-force nearest hit; any-hit mode gives the same hit mask and only
    real blockers."""
    sweeps = _sweeps(case)
    assert any(a[5] for a in sweeps) and not all(a[5] for a in sweeps)
    hits = 0
    for args in sweeps:
        t, win, _ = ck.trace_tiles_plain(*args)
        hits += int((win >= 0).sum())
        for piece, order in ((1, 0), (3, 1), (3, 2)):
            st, sw = _split(args, piece, order)
            if args[5]:
                np.testing.assert_array_equal((sw >= 0).numpy(),
                                              (win >= 0).numpy())
                assert real_blockers(args, sw)
            else:
                np.testing.assert_array_equal(sw.numpy(), win.numpy())
                np.testing.assert_array_equal(st.numpy(), t.numpy())
        if not args[5]:
            bt, bw = _brute(args)
            np.testing.assert_array_equal(bw.numpy(), win.numpy())
            np.testing.assert_array_equal(bt.numpy(), t.numpy())
    assert hits > 0


@pytest.mark.parametrize("kc,qmask", [(256, 0), (512, 2047)])
def test_epilogue_t_is_bit_equal_to_the_plain_t(kc, qmask):
    args = _rand_sweep(kc, 7 + kc) + (False, qmask)
    t, win, _ = ck.trace_tiles_plain(*args)
    assert int((win >= 0).sum()) > 100
    got = ck.winner_t(args[3], args[4], win)
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  t.view(torch.int32).numpy())
    words = ck.pack_words(t, _list_index(args[1], win, kc), args[4], qmask)
    ut, uw = ck.unpack_words(words, args[1], args[3], args[4], qmask)
    np.testing.assert_array_equal(uw.numpy(), win.numpy())
    np.testing.assert_array_equal(ut.view(torch.int32).numpy(),
                                  t.view(torch.int32).numpy())


def test_card_contract_and_least_work_on_a_frame_sweep():
    """The card's sweep contract (chip_smoke.py phase 7) accepts a split
    result and refuses a wrong winner; the least work of a sweep counts
    only entries at or before each ray's final key."""
    sweeps = _frame_sweeps("fine_forced")
    for args in sweeps:
        ref = ck.trace_tiles_plain(*args)
        got = _split(args, 2, 0) + (ref[2] + 1,)
        res = sweep_contract(got, ref, args)
        assert res["entries"] == int(ref[2].sum()) + ref[2].numel()
        work = k3_work(args, ref)
        listed = int(args[0].sum()) * 256 * args[3].shape[2]
        assert 0 < work["lane_tests"] <= listed
        assert work["bound_by"] in ("operations", "bytes")
        if args[5] or not bool((ref[1] >= 0).any()):
            continue
        bad = ref[1].clone()
        bad[int(torch.nonzero(bad >= 0)[0, 0])] += 1
        with pytest.raises(AssertionError):
            sweep_contract((ref[0], bad, ref[2]), ref, args)


def _hand_sweep(case):
    """One tile of 256 rays from z = 3 against a unit icosphere in 5
    clusters of 16 triangles. "hit": rays toward the sphere, a tinit of 10
    and the last entry at t = 9, past every hit; "miss": rays away from it
    under a tinit of 3, entries at t = 0.5 to 5, one of them at 3;
    "short": a list of 2 of the 5 clusters, its padding entered at t = 0."""
    tris = make_icosphere(1)
    mc = pmc.build_clusters(tris[:, 0], tris[:, 1], tris[:, 2],
                            np.zeros(len(tris), np.int32), kc=16)
    C = mc.n_clusters
    rng = np.random.RandomState(3)
    xy = rng.uniform(-0.5, 0.5, (256, 2)).astype(np.float32)
    o = np.concatenate([xy, np.full((256, 1), 3.0, np.float32)], 1)
    d = np.float32([0, 0, -1 if case == "hit" else 1]) * np.ones((256, 1),
                                                                np.float32)
    tinit = {"hit": 10.0, "miss": 3.0, "short": 10.0}[case]
    rays = np.concatenate([o, d, np.full((256, 1), 1e-3, np.float32),
                           np.full((256, 1), tinit, np.float32)], 1)
    entry = {"hit": [0.0, 0.0, 0.0, 0.0, 9.0],
             "miss": [0.5, 1.0, 3.0, 3.5, 5.0],
             "short": [0.5, 1.0, 0.0, 0.0, 0.0]}[case]
    lens = 2 if case == "short" else C
    t = torch.from_numpy
    return (torch.tensor([lens], dtype=torch.int32),
            t(rng.permutation(C).astype(np.int32)[None]),
            torch.tensor([entry], dtype=torch.float32), mc.gmat,
            t(np.ascontiguousarray(rays, np.float32)), False,
            {"hit": 0, "miss": 2047, "short": 0}[case])


@pytest.mark.parametrize("case", ["hit", "miss", "short"])
def test_k3_least_work_equals_a_brute_force_count(case):
    """``k3_work`` counts, for each ray, kc lane-tests of every listed
    entry whose key is at most the ray's final key (the plain winner's, or
    key(tinit) without a hit), and never a padding entry; its bytes are
    each input read once and each output written once."""
    args = _hand_sweep(case)
    lens, ids, entry_t, gmat, rays, _, qmask = args
    C, kc = ids.shape[1], gmat.shape[2]
    assert C == 5 and kc == 16
    ref = ck.trace_tiles_plain(*args)
    hit = ref[1] >= 0
    final = [ck.key_of(ref[0][i:i + 1] if hit[i] else rays[i, 7:8],
                       qmask).item() for i in range(256)]
    keys = ck.key_of(entry_t[0], qmask).tolist()
    tests = sum(kc for i in range(256) for e in range(int(lens[0]))
                if keys[e] <= final[i])
    work = k3_work(args, ref)
    assert work["lane_tests"] == tests
    assert work["bytes"] == 4 * (1 + 2 * C + 12 * C * kc + 8 * 256) \
        + 8 * 256 + 4
    if case == "hit":
        assert bool(hit.all()) and 0 < tests < 256 * C * kc
    else:
        assert not bool(hit.any())
        assert tests == 256 * {"miss": 3, "short": 2}[case] * kc
