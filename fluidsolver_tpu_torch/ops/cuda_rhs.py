"""Kernel 13, ``fused_rhs``: one two-phase subiteration's pressure
right-hand side (divergence, capillary pressure jump and its increment) in
one launch.

CUDA source: ``csrc/rhs.cu``; replaces no TPU kernel (the JAX package's
``jnp`` sequence, which XLA fuses on the TPU). The plain PyTorch twin is
the unfused sequence: ``stencil.divergence``, ``mom.calc_pressure_jump``,
and the jump increment over the face densities added on the interior.
"""

from __future__ import annotations

import torch

from fluidsolver_tpu_torch.core import fields
from fluidsolver_tpu_torch.ops import momentum as mom
from fluidsolver_tpu_torch.ops import stencil
from fluidsolver_tpu_torch.poisson import _kernels


def fused_rhs_twin(U, V, vf_old, curv, iface_len, rho_u, rho_v, pj_u_old, pj_v_old, dt, *,
                   sigma: float, dx: float, dy: float):
    """The plain PyTorch version (same contract as :func:`fused_rhs`)."""
    div = stencil.divergence(U, V, dx, dy)
    pj_u, pj_v = mom.calc_pressure_jump(vf_old, curv, iface_len, sigma, dx, dy)
    dpj_u = pj_u - pj_u_old
    dpj_v = pj_v - pj_v_old
    div = fields.add_interior(div, dt * (
        (dpj_u[2:-1, 1:-1] / rho_u[2:-1, 1:-1] - dpj_u[1:-2, 1:-1] / rho_u[1:-2, 1:-1]) / dx
        + (dpj_v[1:-1, 2:-1] / rho_v[1:-1, 2:-1] - dpj_v[1:-1, 1:-2] / rho_v[1:-1, 1:-2]) / dy
    ))
    return div, pj_u, pj_v


def fused_rhs_cuda(U, V, vf_old, curv, iface_len, rho_u, rho_v, pj_u_old, pj_v_old, dt, *,
                   sigma: float, dx: float, dy: float):
    """Launch the kernel (same contract as :func:`fused_rhs`)."""
    ins = [U, V, vf_old, curv, iface_len, rho_u, rho_v, pj_u_old, pj_v_old]
    _kernels.check(ins + [dt], vf_old.device, vf_old.dtype)
    Nc, M = vf_old.shape
    shapes = [(Nc + 1, M), (Nc, M + 1)] + [(Nc, M)] * 3 + [(Nc + 1, M), (Nc, M + 1)] * 2
    if any(tuple(t.shape) != s for t, s in zip(ins, shapes)) or dt.numel() != 1:
        raise ValueError(f"fused_rhs takes U-, V- and centre-shaped fields of the centre shape "
                         f"{(Nc, M)} and a one-value dt")
    outs = [torch.empty_like(vf_old), torch.empty_like(U), torch.empty_like(V)]
    in_ptrs, out_ptrs = _kernels.ptrs(ins), _kernels.ptrs(outs)
    rc = _kernels.lib().fs_fused_rhs(
        _kernels.dtype_code(vf_old.dtype), in_ptrs, dt.data_ptr(), out_ptrs, Nc, M, dx, dy, sigma,
        _kernels.stream(vf_old.device))
    _kernels.raise_on_error(rc, "fused_rhs")
    return tuple(outs)


def fused_rhs(U, V, vf_old, curv, iface_len, rho_u, rho_v, pj_u_old, pj_v_old, dt, *,
              sigma: float, dx: float, dy: float):
    """(div, p_jump_u, p_jump_v): the divergence of the velocities ``U``,
    ``V`` over the whole centre box, plus on the interior dt times the
    divergence of (p_jump - p_jump_old) / rho on the faces; the jumps
    sigma kappa_face grad(vf_old) on the interior faces (zero ghost rings),
    kappa_face the interface-length-weighted curvature of the face's two
    cells. ``dt`` is a 0-d tensor. Dispatch: the kernel for CUDA tensors,
    the twin for CPU tensors."""
    impl = fused_rhs_twin if _kernels.on_cpu(vf_old) else fused_rhs_cuda
    return impl(U, V, vf_old, curv, iface_len, rho_u, rho_v, pj_u_old, pj_v_old, dt, sigma=sigma,
                dx=dx, dy=dy)
