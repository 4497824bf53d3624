"""The cluster sweep's cull and resolve kernels (``ops/csrc/cluster_glue.cu``
through ``mesh_clusters._sweep_kernels``) against their torch twin
(``mesh_clusters._sweep``).

On the CPU: the kernels' code compiled as host C++ (g++, a header that
defines the CUDA keywords away, one thread a block: every loop of a block
strides by its width) behind ``_sweep_kernels``, held bit for bit to the
twin on ``chip_smoke.glue_cases`` (``glue_contract``: K3's arguments from
both, then the Hit, steps and lens), and on a short frame of a toy dragon;
``intersect_clusters``' routing and counters, and the refusal of CPU
tensors. On the card (marked ``cuda``, skipped without one; there run
``python -m pytest --noconftest tests/test_torch_cluster_glue.py``): the
same cases, a list past the cull's sort, and dragon frames through the
kernels against frames through the twin."""

import ctypes
import dataclasses
import re
import shutil
import subprocess
from types import SimpleNamespace

import pytest
import torch

from chip_smoke import glue_case_names, glue_cases, glue_contract, patched
from yetanotherconsolegameengine_tpu_torch.config import DEFAULT_CONFIG
from yetanotherconsolegameengine_tpu_torch.ops import (cluster_kernel,
                                                       kernels, mesh_clusters)
from yetanotherconsolegameengine_tpu_torch.ops.intersect import INF
from yetanotherconsolegameengine_tpu_torch.render.renderer import (
    RaytraceRenderer)
from yetanotherconsolegameengine_tpu_torch.scene.builders import SCENE_BUILDERS
from yetanotherconsolegameengine_tpu_torch.scene.mesh_scenes import (
    FORCED_SCENE_BUILDERS)
from yetanotherconsolegameengine_tpu_torch.utils import profiling

torch.set_num_threads(1)

# What the CUDA source needs to compile as host C++: the keywords defined
# away, shared memory as statics, one thread a block, no error.
HOST_SHIM = """#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
struct Dim3 { unsigned x, y, z; };
static Dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline void __syncthreads() {}
inline int atomicAdd(int* p, int v) { int old = *p; *p += v; return old; }
inline float __int_as_float(int x) { float f; std::memcpy(&f, &x, 4); return f; }
inline float __uint_as_float(unsigned x) { float f; std::memcpy(&f, &x, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned x; std::memcpy(&x, &f, 4); return x; }
"""
DYNAMIC = "extern __shared__ unsigned long long s_pairs[];"
LAUNCH = re.compile(r"(\w+)<<<[^>]*>>>\((.*?)\);", re.S)
# Blocks of one thread a launch runs on the host: a ray each, or a tile.
HOST_BLOCKS = {"prep_kernel": "n_pad", "cull_kernel": "n_tiles",
               "resolve_kernel": "n_pad"}
ENTRIES = ("yacge_cluster_prep_launch", "yacge_cluster_cull_launch",
           "yacge_cluster_resolve_launch")


def host_source(src: str) -> str:
    """The kernels' source with the dynamic shared array a static one and
    each launch a loop of one-thread blocks."""
    assert DYNAMIC in src
    src = src.replace(DYNAMIC, "static unsigned long long s_pairs[kSortMax];")

    def loop(m):
        return (f"for (unsigned b = 0; b < (unsigned)({HOST_BLOCKS[m[1]]}); "
                f"++b) {{ blockIdx.x = b; {m[1]}({m[2]}); }}")
    src, n = LAUNCH.subn(loop, src)
    assert n == len(HOST_BLOCKS)
    return src


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """The three launchers of the kernels' source built for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' threads for the host")
    out = tmp_path_factory.mktemp("glue_host")
    (out / "cuda_runtime.h").write_text(HOST_SHIM)
    (out / "glue_host.cpp").write_text(
        host_source((kernels.CSRC / "cluster_glue.cu").read_text()))
    so = out / "libglue_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-fPIC",
                    "-shared", f"-I{out}", f"-I{kernels.CSRC}", "-o",
                    str(so), str(out / "glue_host.cpp")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    fns = {}
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = kernels._SIGNATURES[name]
        fns[name] = fn
    return SimpleNamespace(**fns)


def _host_require(t, name, dtype, shape=None):
    """``kernels.require`` less its device check."""
    if t.dtype != dtype:
        raise TypeError(name)
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(name)
    if not t.is_contiguous():
        raise ValueError(name)


@pytest.fixture
def on_host(host_library, monkeypatch):
    """``_sweep_kernels`` launching the host build on CPU tensors (K3 there
    its plain version); yields the launch counts' table."""
    monkeypatch.setattr(kernels, "require", _host_require)
    monkeypatch.setattr(kernels, "library", lambda: host_library)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=None))
    kernels.reset_launches()
    yield kernels.LAUNCHES
    kernels.reset_launches()


@pytest.fixture(scope="module")
def cpu_cases():
    cases = glue_cases(torch.device("cpu"))
    assert list(cases) == glue_case_names()
    return cases


@pytest.mark.parametrize("name", glue_case_names())
def test_host_threads_equal_the_torch_twin(name, cpu_cases, on_host):
    """Each case: K3's lens, ids, entry_t and rays, then t, n, u, v, mat,
    hit, steps and lens bit-equal to the twin's; three launches a sweep,
    none for no rays."""
    report, _ = glue_contract(*cpu_cases[name])
    n = int(name != "no_rays")
    if n:
        assert report["hits"] > 0 and report["listed"] > 0
    assert (on_host["cluster_prep"], on_host["cluster_cull"],
            on_host["cluster_resolve"]) == (n, n, n)


def test_the_cases_reach_every_branch(cpu_cases):
    """The cases hold what the kernels must match the twin on: lanes out
    of play, padded tiles, zero and -0 direction components, NaN and
    infinite lanes, negative and empty windows, a proxy set's t_bias, kc
    256 and 512, a set past the cull's sort, both modes and both orders."""
    seen = set()
    for name, (mc, o, d, lo, hi, any_hit, presort) in cpu_cases.items():
        P = o.shape[0]
        seen.add(("kc", mc.kc))
        seen.add(("past_sort", mc.n_clusters > mesh_clusters.SORT_MAX))
        seen.add(("mode", any_hit, presort))
        seen.add(("lanes", isinstance(lo, torch.Tensor)))
        if P:
            seen.add(("padded", P % mesh_clusters.TILE != 0))
            seen.add(("parked", bool((o.abs() >= 1e30).any())))
        if isinstance(lo, torch.Tensor):
            seen.add(("negative", bool((lo < 0).any())))
            seen.add(("empty", bool((hi < lo).any())))
            seen.add(("biased", bool((lo == mc.t_bias).all())
                      and mc.t_bias > 0))
        if P > 12:
            seen.add(("signed_zero", bool(torch.signbit(d[6, 0]))
                      and float(d[5, 0]) == 0.0))
            seen.add(("nan", bool(o[8].isnan().any() and d[9].isnan().any())))
            seen.add(("inf", bool(d[10].isinf().any())))
    assert {("kc", 4), ("kc", 256), ("kc", 512), ("past_sort", True),
            ("past_sort", False), ("lanes", True), ("lanes", False),
            ("padded", True), ("parked", True), ("negative", True),
            ("empty", True), ("biased", True), ("signed_zero", True),
            ("nan", True), ("inf", True)} <= seen
    assert {("mode", a, p) for a in (False, True)
            for p in (False, True)} <= seen


def test_cull_refuses_a_sort_it_cannot_hold(on_host):
    """The cull's launcher refuses a pair count that is no power of two,
    below the clusters, or past its shared memory."""
    fn = kernels.library().yacge_cluster_cull_launch
    for n_pairs, n_clusters in ((24, 20), (16, 20),
                                (2 * mesh_clusters.SORT_MAX, 5000)):
        assert fn(None, None, None, None, None, 1, n_clusters, n_pairs,
                  None, None, None, None, None) != 0


# A dragon frame of one bounce and one shadow step on the CPU.
SHORT = dataclasses.replace(DEFAULT_CONFIG, diffuse_bounces=0,
                            max_mirror_bounces=0, max_refractions=1)


def _frame(scene):
    r = RaytraceRenderer(scene, 16, 8, cfg=SHORT, device="cpu")
    profiling.reset()
    out = r.render()
    planes = {f.name: getattr(out, f.name).clone()
              for f in dataclasses.fields(out)}
    return planes, dict(profiling.SYNCS), dict(profiling.COUNTS)


def test_frames_through_the_host_kernels_equal_the_twin(on_host,
                                                        monkeypatch):
    """A short ``cluster_forced`` frame with every sweep through
    ``_sweep_kernels`` (the host build behind it) has the planes of the
    twin's frame bit for bit; its sweeps count under
    ``clusters.kernel_sweeps``, the twin's under ``clusters.plain_sweeps``,
    three launches a sweep; the kernels' path drops the twin's bound
    uploads and adds no other host wait."""
    scene = FORCED_SCENE_BUILDERS["cluster_forced"]()
    plain, plain_syncs, plain_counts = _frame(scene)
    n = plain_counts["clusters.sweeps"]
    assert n > 0 and plain_counts["clusters.plain_sweeps"] == n
    assert "clusters.kernel_sweeps" not in plain_counts
    monkeypatch.setattr(mesh_clusters, "resolve_impl",
                        lambda impl, dev: "kernel")
    kernels.reset_launches()
    got, syncs, counts = _frame(scene)
    assert counts["clusters.kernel_sweeps"] == counts["clusters.sweeps"] == n
    assert "clusters.plain_sweeps" not in counts
    assert (on_host["cluster_prep"], on_host["cluster_cull"],
            on_host["cluster_resolve"]) == (n, n, n)
    for key, x in plain.items():
        assert torch.equal(x, got[key]), key
    assert "mesh_clusters.bound_upload" not in syncs
    plain_syncs.pop("mesh_clusters.bound_upload", None)
    assert syncs == plain_syncs


def test_the_kernel_path_refuses_cpu_tensors():
    """``impl="kernel"`` off CUDA raises before any count or launch, and
    ``_sweep_kernels`` refuses CPU rays."""
    mc = FORCED_SCENE_BUILDERS["cluster_forced"]().mesh_clusters
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    profiling.reset()
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        mesh_clusters.intersect_clusters(mc, o, d, 1e-3, INF, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        mesh_clusters._sweep_kernels(mc, o, d, 1e-3, INF, False, True)
    assert kernels.LAUNCHES == before
    assert "clusters.kernel_sweeps" not in profiling.COUNTS


def test_plain_impl_counts_plain_sweeps():
    """``impl="plain"`` runs the twin and counts it under
    ``clusters.plain_sweeps``, once a call."""
    mc = FORCED_SCENE_BUILDERS["cluster_forced"]().mesh_clusters
    o = torch.tensor([[0.0, 1.0, 6.0]] * 300)
    d = torch.tensor([[0.0, -0.1, -1.0]] * 300)
    profiling.reset()
    for _ in range(2):
        mesh_clusters.intersect_clusters(mc, o, d, 1e-3, INF, impl="plain")
    assert profiling.COUNTS["clusters.plain_sweeps"] == 2
    assert profiling.COUNTS["clusters.sweeps"] == 2
    assert "clusters.kernel_sweeps" not in profiling.COUNTS
    profiling.reset()


# ---- on the card ----------------------------------------------------------


@pytest.fixture(scope="module")
def card_cases():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = glue_cases(torch.device("cuda", 0))
    assert list(cases) == glue_case_names()
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("name", glue_case_names())
def test_glue_kernels_match_the_twin(name, card_cases):
    """Each case on the card: K3's arguments, then the Hit, steps and lens
    bit-equal to the twin's; three launches a sweep, none for no rays."""
    before = dict(kernels.LAUNCHES)
    report, _ = glue_contract(*card_cases[name])
    torch.cuda.synchronize()
    n = int(name != "no_rays")
    for key in ("cluster_prep", "cluster_cull", "cluster_resolve"):
        assert kernels.LAUNCHES[key] == before[key] + n, key
    if n:
        assert report["hits"] > 0 and report["listed"] > 0


@pytest.mark.cuda
def test_a_set_past_the_sort_orders_its_lists_with_torch(card_cases):
    """The 4,141-cluster plane: the cull writes the keys and torch.sort
    orders them: each tile's ids a permutation of the clusters, their
    entry distances ascending, some listed."""
    mc, o, d, lo, hi, any_hit, presort = card_cases["many_clusters_nearest"]
    assert mc.n_clusters > mesh_clusters.SORT_MAX
    seen = []
    with patched(cluster_kernel, "trace_tiles",
                 lambda *a: seen.append(a) or cluster_kernel.trace_tiles_plain(
                     *a)):
        mesh_clusters._sweep_kernels(mc, o, d, lo, hi, any_hit, presort)
    lens, ids, entry_t = seen[0][:3]
    assert ids.dtype == torch.int32 and entry_t.shape == ids.shape
    assert bool((lens > 0).all()) and int(lens.max()) <= mc.n_clusters
    every = torch.arange(mc.n_clusters, device=ids.device)
    assert torch.equal(ids.sort(1).values, every.expand_as(ids).int())
    assert bool((entry_t[:, :-1] <= entry_t[:, 1:]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["dragon", "fine_forced"])
def test_frames_through_the_kernels_equal_frames_through_the_twin(
        scene, card_cases, monkeypatch):
    """Three frames through the cull and resolve kernels against the same
    frames with the twin (K3's kernel behind both): every plane bit for
    bit, with the same host waits but the twin's bound uploads; every
    sweep counted under ``clusters.kernel_sweeps``, three launches each."""
    build = (SCENE_BUILDERS if scene == "dragon" else FORCED_SCENE_BUILDERS)
    s = build[scene]().to("cuda")

    def frames():
        r = RaytraceRenderer(s, 64, 36, device="cuda")
        out = []
        for k in range(3):
            r.set_camera(r.cam_pos, r.yaw + 0.05 * k, r.pitch)
            kernels.reset_launches()
            frame = r.render()
            torch.cuda.synchronize()
            out.append(({f.name: getattr(frame, f.name).clone()
                         for f in dataclasses.fields(frame)},
                        dict(profiling.SYNCS), dict(profiling.COUNTS),
                        dict(kernels.LAUNCHES)))
        return out

    kernel = frames()

    def twin(mc, o, d, tmin, tmax, any_hit, presort):
        with patched(cluster_kernel, "trace_tiles_plain",
                     cluster_kernel.trace_tiles):
            return mesh_clusters._sweep(mc, o, d, tmin, tmax, any_hit,
                                        presort)
    monkeypatch.setattr(mesh_clusters, "_sweep_kernels", twin)
    plain = frames()
    for k, ((want, want_s, _, _), (got, syncs, counts, launches)) in \
            enumerate(zip(plain, kernel)):
        for key, x in want.items():
            assert torch.equal(x, got[key]), (k, key)
        n = counts["clusters.kernel_sweeps"]
        assert n == counts["clusters.sweeps"] > 0, k
        assert launches["cluster_cull"] == launches["cluster_resolve"] == n
        assert "mesh_clusters.bound_upload" not in syncs, k
        want_s.pop("mesh_clusters.bound_upload", None)
        assert syncs == want_s, k
