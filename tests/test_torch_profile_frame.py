"""The frame profiler's bookkeeping (its measurements need a CUDA card)."""

import torch

from yetanotherconsolegameengine_tpu_torch.tools import profile_frame as pf


def test_union_counts_overlaps_once():
    assert pf.union_ms([]) == 0.0
    assert pf.union_ms([(0, 1000), (500, 1500), (2000, 2500),
                        (2100, 2200)]) == 2.0


def test_busy_by_stage_takes_the_innermost_stage():
    k3, cull, ic = (pf.STAGES[i][1] for i in range(1, 4))
    spans = {ic: [(0, 100)], cull: [(10, 30)], k3: [(40, 60)]}
    ops = [(12, 20, "cull"), (40, 50, "k3"), (70, 90, "resolve"),
           (200, 210, "shade")]
    got = pf.busy_by_stage(ops, spans)
    assert got == {cull: 0.008, k3: 0.01, ic: 0.02, pf.OTHER: 0.01}
    assert abs(sum(got.values()) - pf.union_ms([o[:2] for o in ops])) < 1e-12


def test_refuses_to_run_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    assert pf.main([]) != 0
    assert not list(tmp_path.iterdir())


def test_kernel_records_count_each_wrapper_launch_once():
    """One record a launch of K2, K1 (either launch), K3 (its epilogue)
    and the walk, DDA and primitive kernels, by the names the profiler
    reports on the card; other kernels, K3's init and sweep kernels,
    copies and look-alike names count for none."""
    names = [
        "void (anonymous namespace)::trace_kernel(float const*, int const*)",
        "trace_kernel",
        "(anonymous namespace)::post_persistent((anonymous namespace)::Post)",
        "void (anonymous namespace)::post_band_tail(float const*, int)",
        "(anonymous namespace)::epilogue_kernel((anonymous namespace)::"
        "Sweep, int)",
        "(anonymous namespace)::init_kernel((anonymous namespace)::Sweep, "
        "int)",
        "(anonymous namespace)::sweep_kernel((anonymous namespace)::Sweep)",
        "Memcpy HtoD (Pageable -> Device)",
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<float>>(int, at::native::FillFunctor<float>)",
        "(anonymous namespace)::bvh_walk_kernel(float4 const*, int, float "
        "const*)",
        "(anonymous namespace)::dda_march_kernel(short const*, int, int)",
        "(anonymous namespace)::prim_kernel((anonymous namespace)::Tables, "
        "int, float const*)",
        "my_trace_kernel(int)", "post_persistent_v2(int)",
        "bvh_walk_kernel_v2(int)", "prim_kernel_v2(int)"]
    assert pf.kernel_records(names) == {"trace": 2, "post": 2, "clusters": 1,
                                        "bvh": 1, "dda": 1, "prim": 1}
    assert pf.kernel_records([]) == {"trace": 0, "post": 0, "clusters": 0,
                                     "bvh": 0, "dda": 0, "prim": 0}


def test_lost_records_names_the_kernels_short_of_their_launches():
    records = pf.kernel_records(["trace_kernel(int)", "post_persistent(P)",
                                 "post_band_tail(int)",
                                 "bvh_walk_kernel(float4 const*)"])
    assert pf.lost_records({"trace": 1, "post": 2, "clusters": 0, "bvh": 1,
                            "dda": 0, "prim": 0}, records) == {}
    assert pf.lost_records({"trace": 3, "post": 2, "clusters": 4, "bvh": 2,
                            "dda": 5, "prim": 0}, records) == {
        "trace": (3, 1), "clusters": (4, 0), "bvh": (2, 1), "dda": (5, 0)}
