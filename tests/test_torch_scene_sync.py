"""The port's SCNE snapshots against the JAX package's: the same bytes for
the same scene, each package reads the other's, a TCP round trip, the
rejection of hostile streams, and a replica that renders as the original."""

import io
import struct

import numpy as np
import pytest
import torch

from tests.test_torch_scene import flatten_jax_scene
from yetanotherconsolegameengine_tpu.net import scene_sync as jsync
from yetanotherconsolegameengine_tpu.scene import builders as jbuilders
from yetanotherconsolegameengine_tpu_torch.net import scene_sync as psync
from yetanotherconsolegameengine_tpu_torch.render.renderer import (
    RaytraceRenderer)
from yetanotherconsolegameengine_tpu_torch.scene import builders
from yetanotherconsolegameengine_tpu_torch.scene.showcase_scenes import (
    build_exhibit_ring)

# The suite runs several xdist workers beside JAX's own thread pools;
# torch's per-process intra-op pool would oversubscribe the cores.
torch.set_num_threads(1)

SCENES = ["cornell", "demo_random", "primitives", "test", "bunny"]
TABLES = tuple(psync._TABLE_FIELDS)


def _synced(flat: dict) -> dict:
    """The keys a snapshot carries (tables, sky, ambient, defaults)."""
    keep = {k for k in flat if k.split(".")[0] in TABLES}
    keep |= {"ambient_color", "ambient_intensity", "bg_top", "bg_bottom"}
    return {k: np.asarray(flat[k]) for k in keep}


@pytest.mark.parametrize("name", SCENES)
def test_snapshot_bytes_equal_jax(name):
    data = psync.write_snapshot(builders.SCENE_BUILDERS[name]())
    assert data[:4] == b"SCNE"
    assert data == jsync.write_snapshot(jbuilders.SCENE_BUILDERS[name]())


@pytest.mark.parametrize("name", ["cornell", "demo_random"])
def test_each_package_reads_the_other(name):
    """The port reads JAX-written bytes into the port's tables; the JAX
    package reads the port's bytes into its own."""
    psc = builders.SCENE_BUILDERS[name]()
    jsc = jbuilders.SCENE_BUILDERS[name]()
    mine = psync.read_snapshot(io.BytesIO(jsync.write_snapshot(jsc)),
                               device="cpu")
    want = _synced(psc.to_numpy())
    got = _synced(mine.to_numpy())
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert mine.defaults == tuple(np.float32(psc.defaults).tolist())
    assert mine.binary_shadows == psc.binary_shadows
    assert mine.any_transparent == psc.any_transparent
    assert mine.mesh is None and mine.textures is None
    theirs = jsync.read_snapshot(io.BytesIO(psync.write_snapshot(psc)))
    tflat = _synced(flatten_jax_scene(theirs))
    for k, v in _synced(flatten_jax_scene(jsc)).items():
        np.testing.assert_array_equal(tflat[k], v, err_msg=k)


def test_snapshot_of_a_dynamic_frame():
    """A frame of the exhibit ring (patched light and sphere rows) goes
    over the wire with its patches."""
    ring = build_exhibit_ring()
    frame = ring.at_time(1.3)
    back = psync.read_snapshot(io.BytesIO(psync.write_snapshot(frame)),
                               device="cpu")
    assert torch.equal(back.lights.pos, frame.lights.pos)
    assert torch.equal(back.spheres.center, frame.spheres.center)
    assert not torch.equal(back.lights.pos, ring.base.lights.pos)


def test_bad_streams_rejected():
    with pytest.raises(ValueError):
        psync.read_snapshot(io.BytesIO(b"NOPE" + b"\0" * 64), device="cpu")
    data = psync.write_snapshot(builders.SCENE_BUILDERS["cornell"]())
    off = 8
    (nlen,) = struct.unpack_from("<H", data, off)
    dims_off = off + 2 + nlen + 2
    for bad in (2**30, -7):
        tampered = bytearray(data)
        struct.pack_into("<i", tampered, dims_off, bad)
        with pytest.raises(ValueError):
            psync.read_snapshot(io.BytesIO(bytes(tampered)), device="cpu")
    tampered = bytearray(data)
    tampered[off + 2 + nlen] = 250
    with pytest.raises(ValueError):
        psync.read_snapshot(io.BytesIO(bytes(tampered)), device="cpu")
    with pytest.raises(EOFError):
        psync.read_snapshot(io.BytesIO(data[:-3]), device="cpu")


def test_server_client_over_tcp():
    scene = builders.SCENE_BUILDERS["cornell"]()
    server = psync.SceneSyncServer(lambda: scene)
    try:
        client = psync.SceneSyncClient("127.0.0.1", server.port,
                                       device="cpu")
        for _ in range(2):                 # clients re-pull
            replica = client.resync()
            assert torch.equal(replica.rects.k, scene.rects.k)
            assert torch.equal(replica.boxes.bmax, scene.boxes.bmax)
        client.close()
        # A JAX client reads the port's server.
        jclient = jsync.SceneSyncClient("127.0.0.1", server.port)
        np.testing.assert_array_equal(np.asarray(jclient.resync().rects.k),
                                      scene.rects.k.numpy())
        jclient.close()
    finally:
        server.close()


def test_replica_renders_identically():
    scene = builders.SCENE_BUILDERS["cornell"]()
    replica = psync.read_snapshot(io.BytesIO(psync.write_snapshot(scene)),
                                  device="cpu")
    outs = [RaytraceRenderer(s, 20, 12, device="cpu").render()
            for s in (scene, replica)]
    assert torch.equal(outs[0].top_rgb, outs[1].top_rgb)
    assert torch.equal(outs[0].fg_ansi, outs[1].fg_ansi)


def test_read_snapshot_wants_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    data = psync.write_snapshot(builders.SCENE_BUILDERS["test"]())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        psync.read_snapshot(io.BytesIO(data))
