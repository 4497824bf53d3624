"""Engine shell: chexel framebuffers, terminal backends, input, main loop.

The JAX package's ``engine/`` on the port's renderer. The host-only
modules (chexel, entity, fly camera, input, terminal backends, window,
terminal loop) are copies of the JAX package's; ``raytrace_entity.py`` and
``program.py`` are ported: they render on the card unless asked for the
CPU, and read frames back to the host once per tick."""
