"""The PyTorch port imports neither jax nor the JAX package: it has to run
on a machine that has PyTorch and CUDA but no jax."""

import ast
import re
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
assert len(mods) >= 40, mods
assert not bad, bad
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _CHECK], capture_output=True, text=True,
                          timeout=120, cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _code_strings(tree):
    """The string constants of a module other than its docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            first = node.body[0] if node.body else None
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    return [node for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs]


def test_port_names_no_path_of_the_jax_package():
    """No module of the port names a file or directory under
    fluidsolver_tpu/ in its code (docstrings may cite the JAX code they
    port), and the native IB set-up code builds from the port's own copy of
    its source into the port's own build directory."""
    root = Path(__file__).resolve().parent.parent
    pkg = root / "fluidsolver_tpu_torch"
    bad = []
    for f in sorted(pkg.rglob("*.py")):
        for node in _code_strings(ast.parse(f.read_text())):
            if re.search(r"(?<![\w/])fluidsolver_tpu(?!_torch)\b", node.value):
                bad.append(f"{f.relative_to(root)}:{node.lineno}: {node.value!r}")
    assert not bad, bad

    from fluidsolver_tpu_torch.ib import _native

    assert _native.SOURCE == pkg / "csrc" / "ib_kernels.cpp" and _native.SOURCE.is_file()
    assert _native.library_path().parent == pkg / "_build"
