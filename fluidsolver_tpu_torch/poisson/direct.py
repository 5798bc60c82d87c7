"""Dense direct pressure solve for small boxes: port of
``fluidsolver_tpu.poisson.direct`` (the reference's small-grid alternative
to its Accelerate backend; the diagonal-preconditioned CG is
``cg.solve_pcg(precond="jacobi")``). The matrix has (N M)^2 entries, so it
is for boxes of a few thousand cells.
"""

from __future__ import annotations

import torch

from fluidsolver_tpu_torch.poisson.linsys import StencilOp


def dense_matrix(op: StencilOp) -> torch.Tensor:
    """The 5-point operator as a dense (N*M, N*M) matrix (row-major cells)."""
    N, M = op.aC.shape
    n = N * M
    k = torch.arange(n, device=op.aC.device)
    A = op.aC.new_zeros((n, n))
    A[k, k] = op.aC.reshape(-1)
    A[k[M:], k[M:] - M] = op.aL.reshape(-1)[M:]
    A[k[:-M], k[:-M] + M] = op.aR.reshape(-1)[:-M]
    south, north = k % M > 0, k % M < M - 1
    A[k[south], k[south] - 1] = op.aB.reshape(-1)[south]
    A[k[north], k[north] + 1] = op.aT.reshape(-1)[north]
    return A


def solve_direct(op: StencilOp, b: torch.Tensor, singular: bool) -> torch.Tensor:
    """Exact solve. The singular all-Neumann system is regularised by the
    rank-one nullspace shift A + e e^T / n, which leaves the zero-mean
    solution of a zero-mean right-hand side unchanged."""
    N, M = op.aC.shape
    n = N * M
    A = dense_matrix(op)
    rhs = b.reshape(-1)
    if singular:
        A = A + 1.0 / n
        rhs = rhs - torch.mean(rhs)
    x = torch.linalg.solve(A, rhs)
    if singular:
        x = x - torch.mean(x)
    return x.reshape(N, M)
