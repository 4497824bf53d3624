"""Nothing a run loads is JAX or the JAX package; the reference loads
nothing of the program. Module names are compared by their top-level
name, taken whole: the port's name begins with the JAX package's."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
JAX_SIDE = {"jax", "jaxlib", "flax", "yetanotherconsolegameengine_tpu"}
PORT = "yetanotherconsolegameengine_tpu_torch"

RUN_CELL = r"""
import json, sys
from benchmark import run
from benchmark.tests.conftest import TINY
result, _, _ = run.run_cell("cornell.play", 2**31 + 5, 1.0, 0,
                            device="cpu", overrides=TINY)
assert result["correct"], result
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_ONLY = r"""
import json, sys
import torch
from benchmark.reference import camera, frame, post, scene, terminal, trace
from benchmark.reference.scenes import cornell, fine_forced, museum
for builder in (cornell, museum, fine_forced):
    s = scene.Scene.from_inputs(builder.build(), "cpu")
    poses = camera.call_poses(lambda t: {"w"}, 1, 1 / 30, s.defaults, 1)
    frame.render_frames(s, {
        "diffuse_bounces": 1, "max_mirror_bounces": 2, "max_refractions": 2,
        "mirror_threshold": 0.9, "seed_salt": 7, "taa_alpha": 0.01,
        "motion_trans_reset": 0.0025, "motion_rot_reset": 0.0025,
        "taa_clamp_radius": 1, "taa_luminance_pad": 0.1,
        "atrous_iterations": 3, "atrous_c_phi": 3.0, "atrous_n_phi": 0.35,
        "atrous_z_phi": 2.0, "atrous_a_phi": 0.2, "diffuse_sigma_deg": 25.0,
        "tone_exposure": 1.0, "tone_gamma": 2.2, "auto_exposure": True,
        "ae_key": 0.18, "ae_speed": 0.2, "ae_min": 0.1, "ae_max": 1.5,
        "tone_saturation": 2.0, "tone_vibrance": 0.0,
        "max_trace_rounds": 24, "path_stack_size": 16,
        "primary_mesh_lod": True, "secondary_mesh_lod": True},
        8, 4, poses[0][1], s.defaults[5],
        frame.init_state(8, 8, "cpu", torch.float32), 1)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_nothing_of_jax():
    loaded = _modules(RUN_CELL)
    assert PORT in loaded      # the run did drive the program
    assert not loaded & JAX_SIDE, sorted(loaded & JAX_SIDE)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules(REFERENCE_ONLY)
    assert PORT not in loaded
    assert not loaded & JAX_SIDE, sorted(loaded & JAX_SIDE)


def test_forbidden_names_compare_whole():
    from benchmark.run import forbidden_modules
    before = set(sys.modules)
    sys.modules.setdefault(PORT + "_probe", sys)   # shares the JAX prefix
    try:
        assert PORT + "_probe" not in forbidden_modules()
        assert not {"yetanotherconsolegameengine_tpu_torch_probe"} & set(
            forbidden_modules())
    finally:
        for m in set(sys.modules) - before:
            del sys.modules[m]
