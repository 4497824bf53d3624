"""Live video and camera frames as scene textures.

Copied from ``yetanotherconsolegameengine_tpu/video/textures.py``. Reader
objects do not ride in ``SceneData``: ``SceneBuilder.add_video_texture``
allocates a texture-bank slot, flags the scene ``has_dynamic_textures``
and registers the (scene name, slot, reader) binding here. The renderer
polls the readers once per ``render_many`` batch and writes fresh frames
into its copy of the bank, and resets TAA history every frame while the
scene is live (render/renderer.py).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# scene name -> [(tex_id, reader)]
_REGISTRY: Dict[str, List[Tuple[int, object]]] = {}


def _close(reader) -> None:
    close = getattr(reader, "close", None)
    if close:
        try:
            close()
        except Exception:
            pass


def register(scene_name: str, tex_id: int, reader) -> None:
    """Bind ``reader`` to (scene, slot). Rebuilding a scene under the same
    name replaces (and closes) any stale reader for that slot — otherwise
    repeated builds in one process leak ffmpeg subprocesses and the
    renderer keeps polling/uploading dead readers every frame."""
    entries = _REGISTRY.setdefault(scene_name, [])
    for i, (tid, old) in enumerate(entries):
        if tid == tex_id:
            if old is not reader:
                _close(old)
            entries[i] = (tex_id, reader)
            return
    entries.append((tex_id, reader))


def readers_for(scene_name: str):
    return _REGISTRY.get(scene_name, ())


def unregister_scene(scene_name: str) -> None:
    for _, reader in _REGISTRY.pop(scene_name, ()):
        _close(reader)


def frame_to_texture(frame: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) reader frame -> linear float32 texture."""
    f = frame.astype(np.float32) / 255.0
    return f * f  # cheap sRGB-ish -> linear (Texture.cs samples raw bytes)
