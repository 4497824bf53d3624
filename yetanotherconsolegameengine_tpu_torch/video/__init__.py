"""Video-to-terminal pipeline: frame readers and video textures copied
from the JAX package's ``video/readers.py`` and ``video/textures.py``
(numpy and subprocess code that imports no JAX), and ``renderer.py``,
the video mode's frame-to-cells conversion in torch."""
