"""The port imports no JAX: with ``jax`` unimportable, every module of
``yetanotherconsolegameengine_tpu_torch`` and ``chip_smoke`` imports, and
no module of the JAX package is loaded."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = r'''
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any "import jax" now raises
import yetanotherconsolegameengine_tpu_torch as port
names = sorted(m.name for m in pkgutil.walk_packages(port.__path__,
                                                      port.__name__ + "."))
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "yetanotherconsolegameengine_tpu"
             or m.startswith("yetanotherconsolegameengine_tpu."))
assert not bad, bad
assert sys.modules["jax"] is None
print(len(names))
'''


def test_port_and_chip_smoke_import_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _CODE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.strip().splitlines()[-1])
    assert n >= 60, n        # every module was walked
