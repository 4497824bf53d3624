"""Networked scene replication (the C# SceneSync layer,
Scenes/SyncScene.cs), ported from the JAX package's ``net/``."""
