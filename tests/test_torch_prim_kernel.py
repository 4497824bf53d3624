"""The primitive kernel (``ops/csrc/prim_kernel.cu``) against its plain
version, the loop over ``intersect.INTERSECTORS``.

On the CPU: ``intersect_scene``'s dispatch and counters, and the kernel's
thread code compiled as host C++ (g++, with a header that defines the CUDA
keywords away and one thread a block) against the plain loop on
``chip_smoke.prim_cases``, bit for bit, and inside a museum frame through
``sweep_primitives``' own host code. On the card (marked ``cuda``, skipped
without one; there run ``python -m pytest --noconftest
tests/test_torch_prim_kernel.py``): the kernel against the plain loop on
the same cases, a captured sweep replayed, and museum frames through the
kernel against frames through the plain pass."""

import ctypes
import dataclasses
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import bit_contract, prim_case_names, prim_cases
from yetanotherconsolegameengine_tpu_torch.config import DEFAULT_CONFIG
from yetanotherconsolegameengine_tpu_torch.ops import intersect, kernels
from yetanotherconsolegameengine_tpu_torch.ops import trace
from yetanotherconsolegameengine_tpu_torch.ops.intersect import (
    INF, intersect_primitives, intersect_scene, sweep_primitives)
from yetanotherconsolegameengine_tpu_torch.render.renderer import (
    RaytraceRenderer)
from yetanotherconsolegameengine_tpu_torch.scene.builders import SCENE_BUILDERS
from yetanotherconsolegameengine_tpu_torch.utils import profiling

torch.set_num_threads(1)

# What the CUDA source needs to compile as host C++: the keywords defined
# away, one thread a block, no error.
HOST_SHIM = """#pragma once
#include <cmath>
#include <cstdint>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
struct Dim3 { unsigned x, y, z; };
static Dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
"""
LAUNCH = "prim_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream_ptr>>>("


def _cr_sqrt(x):
    """torch.sqrt rounded correctly, as the card's sqrt (torch's CUDA
    kernel and the primitive kernel alike) rounds it; torch's vectorised
    CPU sqrt is off by an ulp on about 0.6% of floats."""
    return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``yacge_prim_launch`` of the kernel's source built for the host: the
    launch a loop of one-thread blocks, one a ray."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's threads for the host")
    src = (kernels.CSRC / "prim_kernel.cu").read_text()
    i = src.index(LAUNCH)
    j = src.index(");", i)
    src = (src[:i] + "for (unsigned b = 0; b < (unsigned)n_rays; ++b) { "
           "blockIdx.x = b; prim_kernel(" + src[i + len(LAUNCH):j] + "); }"
           + src[j + 2:])
    out = tmp_path_factory.mktemp("prim_host")
    (out / "cuda_runtime.h").write_text(HOST_SHIM)
    (out / "prim_host.cpp").write_text(src)
    so = out / "libprim_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-fPIC",
                    "-shared", f"-I{out}", f"-I{kernels.CSRC}", "-o",
                    str(so), str(out / "prim_host.cpp")], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(so)).yacge_prim_launch
    fn.argtypes, fn.restype = kernels._SIGNATURES["yacge_prim_launch"]
    return fn


def _host_require(t, name, dtype, shape=None):
    """``kernels.require`` less its device check."""
    if t.dtype != dtype:
        raise TypeError(name)
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(name)
    if not t.is_contiguous():
        raise ValueError(name)


@pytest.fixture
def on_host(host_kernel, monkeypatch):
    """``sweep_primitives`` launching the host build on CPU tensors, and
    torch.sqrt rounded correctly (the plain loop's spheres and cylinders);
    yields the launch counts' table."""
    monkeypatch.setattr(kernels, "require", _host_require)
    monkeypatch.setattr(kernels, "library", lambda: SimpleNamespace(
        yacge_prim_launch=host_kernel))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(torch, "sqrt", _cr_sqrt)
    monkeypatch.setattr(intersect, "_PRIM_ARGS", None)
    kernels.reset_launches()
    yield kernels.LAUNCHES
    kernels.reset_launches()


@pytest.fixture(scope="module")
def cpu_cases():
    cases = prim_cases(torch.device("cpu"), 32, 24)
    assert list(cases) == prim_case_names()
    return cases


@pytest.mark.parametrize("name", prim_case_names())
def test_host_threads_equal_the_plain_loop(name, cpu_cases, on_host):
    """Each case: one launch, t, n, u, v, mat and hit of the kernel's
    threads equal the plain loop's bit for bit."""
    scene, o, d, lo, hi = cpu_cases[name]
    want = intersect_primitives(scene, o, d, lo, hi)
    bit_contract(sweep_primitives(scene, o, d, lo, hi), want)
    assert on_host["prim"] == 1


# A museum frame of one bounce and one shadow step: the plain BVH walk
# on the CPU takes seconds a frame, and several times that profiled.
SHORT = dataclasses.replace(DEFAULT_CONFIG, diffuse_bounces=0,
                            max_mirror_bounces=0, max_refractions=1)


def _museum_frame(w=8, h=4):
    """One short museum frame on the CPU: (its planes, the registry's sync
    sites and counts)."""
    r = RaytraceRenderer(SCENE_BUILDERS["museum"](), w, h, cfg=SHORT,
                         device="cpu")
    profiling.reset()
    out = r.render()
    return ({f.name: getattr(out, f.name).clone()
             for f in dataclasses.fields(out)},
            dict(profiling.SYNCS), dict(profiling.COUNTS))


def test_museum_frame_counts_each_sweep_by_its_pass(on_host, monkeypatch):
    """Under an active profiler a short CPU museum frame counts every
    ``intersect_scene`` call under ``wavefront.prim_plain_sweeps``. The
    same frame with its primitive pass through ``sweep_primitives`` (the
    host build behind it) has the same planes bit for bit and the same
    sync sites: the kernel's wrapper adds no host wait."""
    calls = []
    real = trace.intersect_scene

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(trace, "intersect_scene", spy)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        plain, plain_syncs, plain_counts = _museum_frame()
    assert plain_counts["wavefront.prim_plain_sweeps"] == len(calls) > 0
    assert "wavefront.prim_kernel_sweeps" not in plain_counts
    n = len(calls)
    monkeypatch.setattr(intersect, "intersect_primitives", sweep_primitives)
    got, syncs, counts = _museum_frame()
    assert on_host["prim"] == len(calls) - n
    assert counts["wavefront.prim_plain_sweeps"] == len(calls) - n
    for key, x in plain.items():
        assert torch.equal(x, got[key]), key
    assert syncs == plain_syncs


def test_the_kernel_path_refuses_cpu_tensors():
    """``impl="kernel"`` off CUDA raises at the scene sweep, as
    ``resolve_impl`` makes it; the kernel's wrapper refuses CPU rays."""
    scene = SCENE_BUILDERS["cornell"]()
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        intersect_scene(scene, o, d, 1e-3, INF, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        sweep_primitives(scene, o, d, 1e-3, INF)
    assert kernels.LAUNCHES == before


def test_plain_impl_counts_plain_sweeps():
    """``impl="plain"`` runs the loop and counts it; the kernel counter
    stays absent."""
    scene = SCENE_BUILDERS["cornell"]()
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    profiling.reset()
    got = intersect_scene(scene, o, d, 1e-3, INF, impl="plain")
    bit_contract(got, intersect_primitives(scene, o, d, 1e-3, INF))
    assert profiling.COUNTS["wavefront.prim_plain_sweeps"] == 1
    assert "wavefront.prim_kernel_sweeps" not in profiling.COUNTS
    profiling.reset()


# ---- on the card ----------------------------------------------------------


@pytest.fixture(scope="module")
def card_cases():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = prim_cases(torch.device("cuda", 0), 64, 48)
    assert list(cases) == prim_case_names()
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("name", prim_case_names())
def test_prim_kernel_matches_plain(name, card_cases):
    """Each case: one launch, t, n, u, v, mat and hit bit-equal to the
    plain loop on the card."""
    scene, o, d, lo, hi = card_cases[name]
    before = kernels.LAUNCHES["prim"]
    got = sweep_primitives(scene, o, d, lo, hi)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["prim"] == before + 1
    bit_contract(got, intersect_primitives(scene, o, d, lo, hi))


@pytest.mark.cuda
def test_prim_kernel_replays_from_a_graph(card_cases):
    """A sweep captured in a CUDA graph and replayed on new rays written
    into the captured tensors equals the eager launch on those rays; a
    call counts one launch, a replay none."""
    scene, o, d, lo, hi = card_cases["museum_shadow"]
    o2, d2, lo2, hi2 = card_cases["museum_bounce"][1:]
    so, sd, shi = o.clone(), d.clone(), hi.clone()
    sweep_primitives(scene, so, sd, lo, shi)          # arguments built
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernels.LAUNCHES["prim"]
    with torch.cuda.graph(graph):
        cap = sweep_primitives(scene, so, sd, lo, shi)
    assert kernels.LAUNCHES["prim"] == before + 1
    so.copy_(o2)
    sd.copy_(d2)
    shi.copy_(hi2)
    graph.replay()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["prim"] == before + 1
    bit_contract(cap, sweep_primitives(scene, o2, d2, lo, hi2))
    assert kernels.LAUNCHES["prim"] == before + 2


@pytest.mark.cuda
def test_museum_frames_through_the_kernel_equal_the_plain_pass(
        card_cases, monkeypatch):
    """Four museum frames (eager, captured, replayed twice) through the
    kernel against the same frames with the plain loop in its place: every
    plane bit for bit, the same sync sites; every sweep, replays included,
    counted under ``wavefront.prim_kernel_sweeps``, one launch each."""
    def frames():
        r = RaytraceRenderer(SCENE_BUILDERS["museum"](), 40, 23,
                             device="cuda")
        out = []
        for k in range(4):
            r.set_camera(r.cam_pos, r.yaw + 0.05 * k, r.pitch)
            kernels.reset_launches()
            frame = r.render()
            torch.cuda.synchronize()
            out.append(({f.name: getattr(frame, f.name).clone()
                         for f in dataclasses.fields(frame)},
                        dict(profiling.SYNCS), dict(profiling.COUNTS),
                        kernels.LAUNCHES["prim"]))
        trace._GRAPHS = None
        return out

    kernel = frames()
    monkeypatch.setattr(intersect, "sweep_primitives",
                        lambda *a: intersect_primitives(*a))
    plain = frames()
    for k, ((want, want_s, _, _), (got, syncs, counts, launches)) in \
            enumerate(zip(plain, kernel)):
        for key, x in want.items():
            assert torch.equal(x, got[key]), (k, key)
        assert syncs == want_s, k
        sweeps = counts["wavefront.prim_kernel_sweeps"]
        assert sweeps > 0 and launches == sweeps, k
        assert "wavefront.prim_plain_sweeps" not in counts, k
    assert kernel[-1][2].get("wavefront.graph_replays", 0) > 0
