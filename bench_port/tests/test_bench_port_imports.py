"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port. Top-level module names are compared
whole: ``fluidsolver_tpu_torch`` is not ``fluidsolver_tpu``."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from bench_port import harness

REPO = Path(__file__).resolve().parents[2]

RUN_A_CELL = """
import json, sys, time
sys.path.insert(0, {tests!r})
from bench_port import control, harness, inputs, peaks, program, trace, window
from bench_port.reference import build, compare
from small import small_config
spec = harness.load_spec()
for m in spec["per_layer"]:
    harness.load_reader(m["name"])
for cell in spec["workloads"]:
    config = small_config(harness.load_config(cell["config"]))
    harness.measure(cell, config, harness.load_traffic(cell["traffic"]), 14, 0.5, False,
                    "cpu", time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys, torch
from bench_port.reference import build, compare
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_levels(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                         capture_output=True, text=True, timeout=600).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    tops = _top_levels(RUN_A_CELL.format(tests=str(Path(__file__).parent)))
    assert "fluidsolver_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    tops = _top_levels(REFERENCE_ONLY)
    assert not tops & {"fluidsolver_tpu_torch", *harness.FORBIDDEN}


def test_no_source_of_the_reference_names_the_port():
    for path in (REPO / "bench_port" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in {"fluidsolver_tpu_torch", *harness.FORBIDDEN}, path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fluidsolver_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & set(harness.FORBIDDEN))
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
