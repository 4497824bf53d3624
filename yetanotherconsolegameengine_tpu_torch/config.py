"""Render-quality knobs of the frame.

The fields of ``yetanotherconsolegameengine_tpu/config.py::RenderConfig``
that the port reads, with the same names and defaults
(tests/test_torch_core.py holds the defaults equal), the mesh-routing knobs
of the cluster-mesh path included. The port keeps its own copy so that a
process on the card imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    diffuse_bounces: int = 1
    max_mirror_bounces: int = 2
    max_refractions: int = 2
    mirror_threshold: float = 0.9
    seed_salt: int = 0x9E3779B97F4A7C15

    # Temporal AA
    taa_alpha: float = 0.01
    motion_trans_reset: float = 0.0025
    motion_rot_reset: float = 0.0025
    taa_clamp_radius: int = 1
    taa_luminance_pad: float = 0.10

    # À-trous denoise
    atrous_iterations: int = 3
    atrous_c_phi: float = 3.0
    atrous_n_phi: float = 0.35
    atrous_z_phi: float = 2.0
    atrous_a_phi: float = 0.20

    # Oren–Nayar roughness
    diffuse_sigma_deg: float = 25.0

    # Mesh routing (cluster meshes only). Secondary rays (shadows,
    # bounces) trace the scene's LOD proxy set and primary rays its fine
    # proxy set when the scene ships them (ops/intersect.py).
    secondary_mesh_lod: bool = True
    primary_mesh_lod: bool = True
    # Ray binning before the cluster sweep (ops/mesh_clusters.py presort)
    # for primary and shadow populations; bounce rounds always bin.
    presort_primary: bool = True
    presort_shadow: bool = True
    # Shadow lanes laid out light-major ([light0: all rays][light1: ...])
    # and swept unsorted, on scenes with cluster meshes and two or more
    # lights.
    lmajor_shadow: bool = True
    # Primary lanes in 16x16 pixel-block order (render/renderer.py), which
    # turns presort_primary off for that sweep.
    block_order_primary: bool = True

    # Tone mapping
    tone_exposure: float = 1.0
    tone_gamma: float = 2.2
    auto_exposure: bool = True
    ae_key: float = 0.18
    ae_speed: float = 0.2
    ae_min: float = 0.10
    ae_max: float = 1.50
    tone_saturation: float = 2.0
    tone_vibrance: float = 0.0

    # Path caps: trace rounds per pixel and path-stack slots.
    max_trace_rounds: int = 24
    path_stack_size: int = 16


DEFAULT_CONFIG = RenderConfig()
