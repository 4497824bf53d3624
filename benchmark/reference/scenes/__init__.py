"""One builder a scene, found by the configuration's ``scene`` name:
``scenes/<name>.py`` defines ``build() -> SceneInputs``."""
