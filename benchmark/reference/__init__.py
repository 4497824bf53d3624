"""The benchmark's plain reference renderer, frozen here.

A straightforward PyTorch/NumPy implementation of what the benchmark's
configurations run, written out again from the published algorithms the
program implements (the C# RaytraceEntity scene table and its path
tracer): the scene builders (``scene.py`` and ``scenes/<name>.py``) and
a cluster mesh's proxy sets (``lod.py``), ray generation and the
SplitMix64 sampler (``frame.py``), ray-primitive and triangle
intersection (every triangle of a spatial group whose box a ray meets)
with each population of rays routed to its mesh set, and the
coloured-transmittance wavefront (``trace.py``), TAA, à-trous,
auto-exposure, the ACES tone map and ANSI-256 quantisation
(``post.py``), the fly camera's key response (``camera.py``) and a
terminal that decodes the ANSI byte stream into a screen of cells
(``terminal.py``).

It imports numpy and torch only: nothing of the program and nothing of
JAX. Every float tensor it makes takes the dtype of the scene it is given
(``Scene.to``), so the same code computed in bfloat16 is the benchmark's
lower-precision control.
"""
