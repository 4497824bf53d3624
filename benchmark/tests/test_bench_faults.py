"""The comparison catches a broken timed path, and the control.

Each test drives a whole run of a tiny cell on the CPU (the harness's look
for a card skipped) with the program's frame step broken underneath, and
sees ``correct`` come out false; the control, the reference computed in
bfloat16 in the program's place, has to fail one of the cell's limits.
The faults a cell of this system can have: a step that returns its state
unchanged; half of a batch left out, the other half shown twice; a frame
altered where it is produced (``benchmark/faults.py``, which also reads
them at a cell's own size on the card). There is no exchange between
chips: every cell runs on one.
"""

import pytest

from benchmark import check, faults
from benchmark.run import run_cell
from benchmark.tests.conftest import TINY

SEED = 2**31 + 17


def _run(workload, **kw):
    result, _, _ = run_cell(workload, SEED, 1.0, 0, device="cpu",
                            overrides=TINY, **kw)
    return result


@pytest.fixture
def frame_step(monkeypatch):
    """Replace the port's frame step with ``wrap(real)``."""
    from yetanotherconsolegameengine_tpu_torch.render import renderer

    def install(wrap):
        monkeypatch.setattr(renderer, "frame_step",
                            wrap(renderer.frame_step))
    return install


@pytest.mark.parametrize("workload", ["cornell.play", "cornell.batch8"])
def test_sound_runs_are_correct(workload):
    result = _run(workload)
    assert result["correct"], result["check"]


@pytest.mark.parametrize("workload", ["cornell.play", "cornell.batch8"])
def test_state_returned_unchanged(frame_step, workload):
    frame_step(faults.state_unchanged)
    result = _run(workload)
    assert not result["correct"]
    assert result["check"]["history_mae"]["value"] > \
        result["check"]["history_mae"]["limit"]


def test_half_of_a_batch_left_out(frame_step):
    frame_step(faults.half_batch)
    result = _run("cornell.batch8")
    assert not result["correct"]


@pytest.mark.parametrize("workload", ["cornell.play", "cornell.batch8"])
def test_frame_altered_where_produced(frame_step, workload):
    frame_step(faults.frame_altered)
    result = _run(workload)
    assert not result["correct"]
    assert result["check"]["ansi_flips"]["value"] > \
        result["check"]["ansi_flips"]["limit"]


def test_faults_of_a_cell():
    from benchmark import spec
    from benchmark.run import ROOT
    assert faults.faults_of(spec.load_cell(ROOT, "cornell.play")) == [
        "state_unchanged", "frame_altered"]
    assert faults.faults_of(spec.load_cell(ROOT, "cornell.batch8")) == [
        "state_unchanged", "half_batch", "frame_altered"]


@pytest.mark.parametrize("workload", ["cornell.play", "cornell.batch8"])
def test_the_control_fails_a_limit(workload):
    result, _, _ = run_cell(workload, SEED, 1.0, 0, device="cpu",
                            overrides=TINY, control=True)
    limits = {k: v["limit"] for k, v in result["check"].items()}
    assert result["correct"]
    failed = [k for k in check.CONTROL_NUMBERS
              if result["control"][k] > limits[k]]
    assert failed, result["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["cornell.play", "museum.play",
                                      "cornell.batch8"])
def test_the_control_fails_a_limit_at_the_cells_size(card, workload):
    """On the card, at the cell's own size and load: three seeds."""
    for seed in (SEED, SEED + 1, SEED + 2):
        result, _, _ = run_cell(workload, seed, 3.0, 0, control=True)
        limits = {k: v["limit"] for k, v in result["check"].items()}
        assert result["correct"], result["check"]
        assert any(result["control"][k] > limits[k]
                   for k in check.CONTROL_NUMBERS), result["control"]
