"""The benchmark's plain reference solver: a frozen copy of the plain
PyTorch path of ``fluidsolver_tpu_torch`` as of commit 7fc2dce.

Every kernel's launcher and dispatch layer are gone: each kernel's plain
twin sits in the module that calls it and runs on any device. The
immersed boundaries, the x-slab mesh, the geometric "mg" preconditioner
and the solvers other than PCG are left out. Module docstrings are the port's own. Nothing here
imports the port, so a change to the port cannot change this reference.
"""
