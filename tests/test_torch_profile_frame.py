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
