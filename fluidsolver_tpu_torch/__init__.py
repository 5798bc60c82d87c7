"""PyTorch/CUDA port of ``fluidsolver_tpu`` for NVIDIA Hopper (H100).

The port mirrors the JAX package's module tree (``core/ ops/ poisson/
solvers/ cases/``) and its array conventions (axis 0 = x, one-cell ghost
ring, staggered MAC shapes; see ``core/grid.py``). It imports ``torch``
and never ``jax``.

The BoxMG pressure-solver kernels are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use into ``_build/`` and bound
with ``ctypes`` (``poisson/_kernels.py``). Each kernel module holds the
launching wrapper, its plain PyTorch twin and the dispatch: a CUDA tensor
launches the kernel, a CPU tensor runs the twin.
"""

__version__ = "0.1.0"
