"""World generation and chunk streaming: the numpy worldgen and VG01
files copied from the JAX package, the chunk manager, surface meshing and
the streamed voxel scene re-authored in torch."""
