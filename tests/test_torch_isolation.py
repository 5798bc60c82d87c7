"""The PyTorch port imports neither jax nor the JAX package: it has to run
on a machine that has PyTorch and CUDA but no jax."""

import subprocess
import sys
from pathlib import Path

_CHECK = """
import pkgutil, sys
import fluidsolver_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(fluidsolver_tpu_torch.__path__, "fluidsolver_tpu_torch.")]
for m in mods:
    __import__(m)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "fluidsolver_tpu" or k.startswith("fluidsolver_tpu."))
print(len(mods), bad)
assert len(mods) >= 32, mods
assert not bad, bad
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _CHECK], capture_output=True, text=True,
                          timeout=120, cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr
