"""Build, load and bind the CUDA kernels of ``fluidsolver_tpu_torch/csrc``.

The sources (the BoxMG kernels, the geometric multigrid's red-black
sweep, the fused PCG iteration, the fused momentum stage, the two-phase
pressure right-hand side and the VOF kernels) are compiled with
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface,
at first use, into
``fluidsolver_tpu_torch/_build/`` (named by a hash of the sources and the
flags, so an edited source rebuilds), and bound with ``ctypes``. A missing
compiler, a failed build or a card that is not Hopper raises.

``launches`` counts kernel launches by kernel name; each wrapper adds one
where it launches its kernel.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_rap.cu", "fused_smooth.cu", "tail.cu", "cg.cu", "momentum.cu", "elvira.cu",
           "curvature.cu", "overlap.cu", "rb_sweep.cu", "rhs.cu")
HEADERS = ("boxmg_device.cuh", "vof_device.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_longlong
_SIGNATURES = {
    # dtype, ncoef, op, N, M, out, stream
    "fs_fused_rap": (_I, _I, _P, _I, _I, _P, _P),
    # dtype, ncoef, op, b, x0, tr, ec, Nc, Mc, x_out, r_out, N, M, colors,
    # n_colors, mode, stream
    "fs_fused_smooth": (_I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I,
                        ctypes.c_uint, _I, _I, _P),
    # dtype, ncoef0, op0, N, M, n_levels, buf, stream
    "fs_tail_setup": (_I, _I, _P, _I, _I, _I, _P, _P),
    # dtype, ncoef0, op0, buf, b, x_out, scratch, N, M, n_levels, n_pre,
    # n_post, stream
    "fs_tail_cycle": (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # n_blocks, n_syncs, n_threads, stream (empty barriers, a measurement probe)
    "fs_sync_probe": (_I, _I, _I, _P),
    # dtype, op, x, r, p, rz, N, M, x_out, r_out, Ap (unused, may be null),
    # part, scal, stream
    "fs_step_ab": (_I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P),
    # dtype, r, z_raw, p, rz_prev, sum_r, singular, n, z_out, p_out, part,
    # scal, stream
    "fs_step_c": (_I, _P, _P, _P, _P, _P, _I, _L, _P, _P, _P, _P, _P),
    # dtype, op, b, x0, singular, N, M, x_out, r_out, part, scal, stream
    "fs_step_init": (_I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P),
    # dtype, in (12), dt, out (4), Nc, M, dx, dy, rho_eps, gx, gy, stream
    "fs_fused_momentum": (_I, _P, _P, _P, _I, _I, _D, _D, _D, _D, _D, _P),
    # dtype, in (9), dt, out (3), Nc, M, dx, dy, sigma, stream
    "fs_fused_rhs": (_I, _P, _P, _P, _I, _I, _D, _D, _D, _P),
    # dtype, vf, N, M, dx, dy, lo, hi, out (3 planes), valid, stream
    "fs_elvira": (_I, _P, _I, _I, _D, _D, _D, _D, _P, _P, _P),
    # fs_elvira's arguments (the fills on every cell, no search: a
    # measurement probe)
    "fs_elvira_fill_probe": (_I, _P, _I, _I, _D, _D, _D, _D, _P, _P, _P),
    # dtype, nx, ny, d, valid, N, M, dx, dy, out, stream
    "fs_curvature": (_I, _P, _P, _P, _P, _I, _I, _D, _D, _P, _P),
    # fs_curvature's arguments (0 on every cell, no fit: a measurement probe)
    "fs_curvature_fill_probe": (_I, _P, _P, _P, _P, _I, _I, _D, _D, _P, _P),
    # dtype, slots_x, slots_y, lane_i, lane_j, vf, valid, nx, ny, d, N, M, m,
    # dx, dy, lo, overlap, area, stream
    "fs_overlap": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _D, _D, _P, _P, _P),
    # fs_overlap's arguments, slots_x and slots_y (4, m) quads
    "fs_overlap_quad": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _D, _D, _P, _P, _P),
    # stage (0 an empty launch, 1 without the chains), then fs_overlap's
    # arguments (a measurement probe)
    "fs_overlap_probe": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _D, _D, _P,
                         _P, _P),
    # dtype, op, b, x, x_out, N, M, red_first, stream
    "fs_rb_sweep": (_I, _P, _P, _P, _P, _I, _I, _I, _P),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA kernels cannot be built")
    return found


def library_path(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        # another checkout's csrc may lack a header of this one
        if (csrc / name).exists():
            h.update(name.encode())
            h.update((csrc / name).read_bytes())
    return build_dir / f"libfs_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False, csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the library of the sources in ``csrc`` (the package's own
    by default; another checkout's for an A/B run) into ``build_dir`` if it
    is not built yet; returns its path. Each source compiles in its own
    ``nvcc`` process, all started together, and the objects are linked into
    one shared library. With ``verbose``, ptxas reports registers, shared
    memory and spills."""
    so = library_path(csrc, build_dir)
    if so.exists():
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=build_dir))
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    jobs = []
    for src in SOURCES:
        cmd = [nvcc, *NVCC_FLAGS, *ptxas, "-c", str(csrc / src), "-o", str(work / (src + ".o"))]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True)))
    log, failed = [], []
    for cmd, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-3]} ({proc.returncode}):\n{err[-3000:]}")
    if not failed:
        cmd = [nvcc, *ARCH, "-shared", "-o", str(work / "lib.so"),
               *(str(work / (src + ".o")) for src in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr[-3000:]}")
    (build_dir / "build.log").write_text("\n".join(log))
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    if verbose:
        print("\n".join(log), end="")
    os.replace(work / "lib.so", so)
    shutil.rmtree(work, ignore_errors=True)
    return so


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    major, minor = torch.cuda.get_device_capability()
    if (major, minor) != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; this card is sm_{major}{minor}")
    handle = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def dtype_code(dtype: torch.dtype) -> int:
    """The entry points' dtype argument: 0 float, 1 double, 2 bf16. Only
    ``fs_fused_smooth`` and ``fs_rb_sweep`` take 2; every other entry point
    returns cudaErrorInvalidValue for it, and its wrapper raises."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernels take float32, float64 or bfloat16, not {dtype}")
    return _DTYPE_CODES[dtype]


def torch_dtype(name) -> torch.dtype:
    """A dtype given by name (``"bfloat16"``, ``"float32"``, ...; the
    config's ``pressure_precond_dtype``) or as a torch dtype, as the JAX
    package reads it with ``jnp.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"not a floating-point dtype: {name!r}")
    return dtype


def ptrs(tensors) -> ctypes.Array:
    """A C array of device pointers (kept alive by the caller)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def check(tensors, device, dtype) -> None:
    """Every tensor is contiguous, of ``dtype`` and on CUDA ``device``."""
    for t in tensors:
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"kernel operand must be contiguous {dtype} on {device}; got "
                f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}")


def check_words(tensors, what: str) -> None:
    """Every bf16 tensor starts on 4 bytes: the bf16 kernels load and store
    pairs of neighbouring values as one 4-byte word (their level rows are
    not padded, so a row of odd width starts on 2 bytes every other row,
    which the kernels take; a plane that starts on 2 bytes they do not)."""
    for t in tensors:
        if t.dtype == torch.bfloat16 and t.data_ptr() % 4:
            raise ValueError(f"{what}: a bf16 operand starts on 2 bytes, not 4 (a view at an odd offset); "
                             "pass a contiguous copy")


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launches[name] += 1


def on_cpu(t: torch.Tensor) -> bool:
    """Dispatch: True runs the plain PyTorch twin, False launches the
    kernel; a tensor on any device other than the CPU or a CUDA card
    raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")
