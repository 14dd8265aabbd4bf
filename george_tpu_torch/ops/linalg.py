# -*- coding: utf-8 -*-
"""Dense linear algebra of the GP density, batched over leading axes.

The JAX package leaves these to XLA (``ops/linalg.py``); here they are
``torch.linalg`` calls (cuSOLVER / cuBLAS on the card).  A factorization
that fails (K not positive definite) gives NaN, never an exception, so a
batch of chains carries on and the caller reads NaN as a rejected point.
"""

import torch

__all__ = ["cholesky_factor", "cho_solve", "cho_logdet"]


def cholesky_factor(K):
    """Lower Cholesky factor and log-determinant of SPD matrices (..., N, N).

    Where a factorization fails, the factor is the identity (so that
    autograd through it stays finite) and the log-determinant NaN.
    """
    L, info = torch.linalg.cholesky_ex(K)
    ok = info == 0
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    L = torch.where(ok[..., None, None], L, eye)
    logdet = cho_logdet(L)
    return L, torch.where(ok, logdet, torch.full_like(logdet, float("nan")))


def cho_solve(L, y):
    """Solve K x = y, given the lower Cholesky factor L of K; y is (..., N)."""
    return torch.cholesky_solve(y[..., None], L)[..., 0]


def cho_logdet(L):
    """log det K from its lower Cholesky factor."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                           dim=-1)
