"""ctypes loader of the native IB set-up code (``csrc/ib_kernels.cpp``).

The source is built with ``g++ -O3 -fPIC -shared -std=c++17`` at first use
into ``fluidsolver_tpu_torch/_build/`` (named by a hash of the source and
the flags, so an edited source rebuilds). This is host code that runs once
when a case's IB fields are made, not a device kernel. A missing compiler,
a failed build or a nonzero return raises: there is no fallback. The
Python builders of ``ib/sharp.py`` and ``ib/luchini.py`` serve the shapes
other than a circle.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ib_kernels.cpp"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfs_ib_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native IB set-up code cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        out = work / "lib.so"
        proc = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", str(out)], capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr[-3000:]}")
        os.replace(out, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded library (built on first use)."""
    handle = ctypes.CDLL(str(build()))
    i64, f64 = ctypes.c_int64, ctypes.c_double
    pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    pi = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    pi1 = ctypes.POINTER(ctypes.c_int64)
    handle.luchini_correction_circle.argtypes = [pd, i64, pd, i64, f64, f64, f64, f64, f64, pd]
    handle.luchini_correction_circle.restype = ctypes.c_int
    handle.sharp_stencil_circle.argtypes = [pd, i64, pd, i64, f64, f64, f64, f64, f64, ctypes.c_int,
                                            pi, pi, pi, pd, pd, pi1, pi, pi1]
    handle.sharp_stencil_circle.restype = ctypes.c_int
    return handle


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"native {name} returned {rc}")


def luchini_correction_circle(xs, ys, dx: float, dy: float, cx: float, cy: float, r: float):
    """The Luchini lambda field of a circular wall on the mesh ``xs`` x ``ys``."""
    xs = np.ascontiguousarray(xs, np.float64)
    ys = np.ascontiguousarray(ys, np.float64)
    out = np.zeros((len(xs), len(ys)))
    _check(lib().luchini_correction_circle(xs, len(xs), ys, len(ys), float(dx), float(dy), float(cx),
                                           float(cy), float(r), out), "luchini_correction_circle")
    return out


def sharp_stencil_circle(xs, ys, dx: float, dy: float, cx: float, cy: float, r: float, scheme: str):
    """The sharp-IB stencil of a circular wall: (tgt, nb1, nb2, w1, w2,
    deep) as flat indices and weights."""
    xs = np.ascontiguousarray(xs, np.float64)
    ys = np.ascontiguousarray(ys, np.float64)
    cap = len(xs) * len(ys)
    tgt, nb1, nb2, deep = (np.zeros(cap, np.int64) for _ in range(4))
    w1, w2 = np.zeros(cap), np.zeros(cap)
    n, nd = ctypes.c_int64(cap), ctypes.c_int64(cap)
    _check(lib().sharp_stencil_circle(xs, len(xs), ys, len(ys), float(dx), float(dy), float(cx), float(cy),
                                      float(r), 0 if scheme == "linear" else 1, tgt, nb1, nb2, w1, w2,
                                      ctypes.byref(n), deep, ctypes.byref(nd)), "sharp_stencil_circle")
    k, kd = n.value, nd.value
    return tgt[:k], nb1[:k], nb2[:k], w1[:k], w2[:k], deep[:kd]
