"""Kernel 8, ``fused_momentum``: one two-phase subiteration's momentum
stage (density transport, momentum fluxes, gravity, velocity update) in one
launch.

CUDA source: ``csrc/momentum.cu``; replaces the TPU kernel
``fluidsolver_tpu/ops/pallas_momentum.py:247``. The plain PyTorch twin is
the unfused sequence of ``ops/momentum.py``: ``calc_drhodt`` ->
``update_density`` -> ``calc_dmomdt`` -> gravity on the interior ->
``update_velocity``.
"""

from __future__ import annotations

import torch

from fluidsolver_tpu_torch.core import fields
from fluidsolver_tpu_torch.ops import momentum as mom
from fluidsolver_tpu_torch.poisson import _kernels


def fused_momentum_twin(U, V, U_old, V_old, rho_u_old, rho_v_old, rho_u, rho_v, visc, p,
                        pj_u, pj_v, dt, *, dx: float, dy: float, rho_eps: float,
                        gx: float = 0.0, gy: float = 0.0):
    """The plain PyTorch version (same contract as :func:`fused_momentum`)."""
    drho_u, drho_v = mom.calc_drhodt(U, V, rho_u_old, rho_v_old, dx, dy, rho_eps)
    rho_u, rho_v = mom.update_density(rho_u_old, rho_v_old, drho_u, drho_v, dt, rho_u, rho_v)
    dmomU, dmomV = mom.calc_dmomdt(U, V, rho_u_old, rho_v_old, visc, p, pj_u, pj_v, dx, dy,
                                   rho_eps)
    if gx != 0.0:
        dmomU = fields.add_interior(dmomU, rho_u[1:-1, 1:-1] * gx)
    if gy != 0.0:
        dmomV = fields.add_interior(dmomV, rho_v[1:-1, 1:-1] * gy)
    U, V = mom.update_velocity(U_old, V_old, rho_u_old, rho_v_old, rho_u, rho_v, dmomU, dmomV,
                               dt, U, V)
    return rho_u, rho_v, U, V


def fused_momentum_cuda(U, V, U_old, V_old, rho_u_old, rho_v_old, rho_u, rho_v, visc, p,
                        pj_u, pj_v, dt, *, dx: float, dy: float, rho_eps: float,
                        gx: float = 0.0, gy: float = 0.0):
    """Launch the kernel (same contract as :func:`fused_momentum`)."""
    ins = [U, V, U_old, V_old, rho_u_old, rho_v_old, rho_u, rho_v, visc, p, pj_u, pj_v]
    _kernels.check(ins + [dt], p.device, p.dtype)
    Nc, M = p.shape
    shapes = [(Nc + 1, M), (Nc, M + 1)] * 4 + [(Nc, M)] * 2 + [(Nc + 1, M), (Nc, M + 1)]
    if any(tuple(t.shape) != s for t, s in zip(ins, shapes)) or dt.numel() != 1:
        raise ValueError(f"fused_momentum takes U-, V- and centre-shaped fields of the centre "
                         f"shape {(Nc, M)} and a one-value dt")
    outs = [torch.empty_like(rho_u), torch.empty_like(rho_v), torch.empty_like(U),
            torch.empty_like(V)]
    in_ptrs, out_ptrs = _kernels.ptrs(ins), _kernels.ptrs(outs)
    rc = _kernels.lib().fs_fused_momentum(
        _kernels.dtype_code(p.dtype), in_ptrs, dt.data_ptr(), out_ptrs, Nc, M, dx, dy, rho_eps,
        gx, gy, _kernels.stream(p.device))
    _kernels.raise_on_error(rc, "fused_momentum")
    return tuple(outs)


def fused_momentum(U, V, U_old, V_old, rho_u_old, rho_v_old, rho_u, rho_v, visc, p, pj_u, pj_v,
                   dt, *, dx: float, dy: float, rho_eps: float, gx: float = 0.0,
                   gy: float = 0.0):
    """(rho_u', rho_v', U', V'): the densities rho_old + dt drho/dt and the
    velocities (rho_old U_old + dt dmom/dt) / rho' on the interior faces,
    the base values ``rho_u``, ``rho_v``, ``U``, ``V`` elsewhere (the last
    U row included). ``U``, ``V`` are the midpoint velocities; ``dt`` is a
    0-d tensor. Gravity (``gx``, ``gy``) is added only where non-zero.
    Dispatch: the kernel for CUDA tensors, the twin for CPU tensors."""
    impl = fused_momentum_twin if _kernels.on_cpu(p) else fused_momentum_cuda
    return impl(U, V, U_old, V_old, rho_u_old, rho_v_old, rho_u, rho_v, visc, p, pj_u, pj_v, dt,
                dx=dx, dy=dy, rho_eps=rho_eps, gx=gx, gy=gy)
