"""Where the port runs: the entry points default to the card and raise
without one; ``impl`` defaults from the tensors' device ("kernel" on CUDA,
"plain" on the CPU), and "kernel" on CPU tensors raises instead of running
the plain version."""

import numpy as np
import pytest
import torch

from yetanotherconsolegameengine_tpu_torch import devices
from yetanotherconsolegameengine_tpu_torch.config import DEFAULT_CONFIG
from yetanotherconsolegameengine_tpu_torch.core.camera import CameraPose
from yetanotherconsolegameengine_tpu_torch.ops import (intersect, kernels,
                                                       mesh_clusters, trace)
from yetanotherconsolegameengine_tpu_torch.render import renderer
from yetanotherconsolegameengine_tpu_torch.scene.builders import SCENE_BUILDERS
from yetanotherconsolegameengine_tpu_torch.scene.mesh_loader import (
    make_icosphere)
from yetanotherconsolegameengine_tpu_torch.scene.mesh_scenes import (
    FORCED_SCENE_BUILDERS)

torch.set_num_threads(1)


@pytest.mark.parametrize("device,impl,want", [
    ("cpu", None, "plain"), ("cpu", "plain", "plain"),
    ("cuda", None, "kernel"), ("cuda", "kernel", "kernel"),
    ("cuda", "plain", "plain")])
def test_impl_resolves_from_the_device(device, impl, want):
    assert devices.resolve_impl(impl, device) == want


@pytest.mark.parametrize("impl,err", [("kernel", "CUDA"), ("xla", "impl")])
def test_impl_refuses_kernel_on_the_cpu(impl, err):
    with pytest.raises(ValueError, match=err):
        devices.resolve_impl(impl, torch.device("cpu"))


@pytest.mark.parametrize("make", [
    lambda: renderer.RaytraceRenderer(SCENE_BUILDERS["test"](), 8, 4),
    lambda: renderer.init_state(8, 4),
    lambda: CameraPose.create()], ids=["renderer", "init_state", "camera"])
def test_entry_points_default_to_the_card(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_cpu_entry_points_when_asked():
    r = renderer.RaytraceRenderer(SCENE_BUILDERS["test"](), 8, 4,
                                  device="cpu")
    assert r.impl == "plain" and r.state.history.device.type == "cpu"
    assert CameraPose.create(device="cpu").pos.device.type == "cpu"
    assert renderer.init_state(8, 4, device="cpu").history.shape == (3, 8, 8)


def _mesh_rays():
    tris = make_icosphere(3)
    mc = mesh_clusters.build_clusters(tris[:, 0], tris[:, 1], tris[:, 2],
                                      np.zeros(len(tris), np.int32))
    rng = np.random.RandomState(0)
    o = np.tile(np.float32([[0.0, 0.0, 3.0]]), (300, 1))
    d = np.concatenate([rng.uniform(-0.3, 0.3, (300, 2)),
                        -np.ones((300, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return mc, torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))


def test_cpu_tensors_take_the_plain_sweep_by_default():
    mc, o, d = _mesh_rays()
    before = kernels.LAUNCHES["clusters"]
    got = mesh_clusters.intersect_clusters(mc, o, d, 1e-3, 3e38)
    want = mesh_clusters.intersect_clusters(mc, o, d, 1e-3, 3e38,
                                            impl="plain")
    assert kernels.LAUNCHES["clusters"] == before
    assert float(got.hit.float().mean()) > 0.8
    for k in ("t", "hit", "n", "u", "v"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def test_kernel_on_cpu_tensors_raises_at_every_level():
    mc, o, d = _mesh_rays()
    scene = FORCED_SCENE_BUILDERS["cluster_forced"]()
    seed = torch.zeros(o.shape[0], dtype=torch.int64)
    calls = [
        lambda: mesh_clusters.intersect_clusters(mc, o, d, 1e-3, 3e38,
                                                 impl="kernel"),
        lambda: intersect.intersect_scene(scene, o, d, 1e-3, 3e38,
                                          impl="kernel"),
        lambda: trace.trace_all(scene, o, d, seed, DEFAULT_CONFIG,
                                impl="kernel"),
        lambda: trace.transmittance_to_lights(
            scene, o, d, torch.full((o.shape[0],), 2.0),
            torch.ones(o.shape[0], dtype=torch.bool), DEFAULT_CONFIG,
            impl="kernel")]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
