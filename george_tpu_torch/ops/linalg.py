# -*- coding: utf-8 -*-
"""Dense linear algebra of the GP, batched over leading axes where noted.

The JAX package leaves these to XLA (``ops/linalg.py``); here they are
``torch.linalg`` calls (cuSOLVER / cuBLAS on the card).  A factorization
that fails (K not positive definite) gives NaN, never an exception, so a
batch of chains carries on and the caller reads NaN as a rejected point.

The ``*_fn`` functions are the JAX package's ``factor_fn`` ... ``predict_fn``
as plain functions on tensors: the ones that build a covariance are
factories per kernel tree (``factor_fn(node)(theta, x, diag_noise)``), as
there.  The JAX package's hand-blocked Cholesky (a TPU work-around) is not
carried over: the factorization is ``torch.linalg.cholesky_ex``.
"""

from functools import lru_cache

import torch

from ..dsl import compiler

__all__ = ["cholesky_factor", "cho_solve", "cho_logdet", "build_K",
           "factor_fn", "solve_fn", "dot_solve_fn", "apply_sqrt_fn",
           "inverse_fn", "loglike_fn", "grad_core_fn", "predict_fn"]


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


def build_K(node, theta, x, diag_noise):
    """``K(x, x) + diag(diag_noise)``, differentiable; the diagonal is added
    in one copy of K."""
    K = compiler.kernel_value_fn(node)(theta, x, x)
    return torch.diagonal_scatter(K, torch.diagonal(K) + diag_noise)


@lru_cache(maxsize=None)
def factor_fn(node):
    """``(theta, x, diag_noise) -> (L, logdet)``: build and factorize."""

    def factor(theta, x, diag_noise):
        return cholesky_factor(build_K(node, theta, x, diag_noise))

    return factor


def _columns(y):
    return y[:, None] if y.dim() == 1 else y


def solve_fn(L, y):
    """K^-1 y for a vector (N,) or a matrix (N, K)."""
    out = torch.cholesky_solve(_columns(y), L)
    return out[:, 0] if y.dim() == 1 else out


def dot_solve_fn(L, y):
    """y^T K^-1 y: a scalar for a vector, (K, K) for a matrix (N, K), as
    z^T z with z = L^-1 y."""
    z = torch.linalg.solve_triangular(L, _columns(y), upper=False)
    return torch.sum(z * z) if y.dim() == 1 else z.T @ z


def apply_sqrt_fn(L, r):
    """``r @ L^T``: rows of r acquire covariance L L^T = K (the reference's
    ``r @ U`` with U the upper factor)."""
    return r @ L.T


def inverse_fn(L):
    """The dense K^-1 from its lower factor."""
    return torch.cholesky_inverse(L)


@lru_cache(maxsize=None)
def loglike_fn(node):
    """``(theta, x, r, diag_noise) -> ll``, the marginal log-likelihood of
    the mean-subtracted ``r``, differentiable by autograd."""

    def loglike(theta, x, r, diag_noise):
        L, logdet = cholesky_factor(build_K(node, theta, x, diag_noise))
        alpha = cho_solve(L, r)
        norm = x.shape[0] * torch.log(
            torch.tensor(2.0 * torch.pi, dtype=r.dtype, device=r.device))
        return -0.5 * (norm + logdet + torch.dot(r, alpha))

    return loglike


@lru_cache(maxsize=None)
def grad_core_fn(node):
    """Gradient core of ``GP.grad_log_likelihood``: one reverse pass through
    the Cholesky for the kernel parameters and the per-point log white
    noise.

    ``(theta, wn_vec, x, r, yerr2) -> (g_theta, g_wn_vec, alpha)``.
    """

    def core(theta, wn_vec, x, r, yerr2):
        with torch.enable_grad():
            theta = theta.detach().requires_grad_(True)
            wn_vec = wn_vec.detach().requires_grad_(True)
            K = build_K(node, theta, x, yerr2 + torch.exp(wn_vec))
            L, logdet = cholesky_factor(K)
            alpha = cho_solve(L, r)
            ll = -0.5 * (logdet + torch.dot(r, alpha))
            # An empty kernel's parameters do not enter: zeros.
            g_theta, g_wn = torch.autograd.grad(ll, (theta, wn_vec),
                                                materialize_grads=True)
        return g_theta, g_wn, alpha.detach()

    return core


@lru_cache(maxsize=None)
def predict_fn(node):
    """Conditional prediction core:
    ``(theta, x_train, L, alpha, x_test) -> (Kxs @ alpha, Kxs, K^-1 Kxs^T)``.
    """
    value = compiler.kernel_value_fn(node)

    def predict(theta, x_train, L, alpha, x_test):
        Kxs = value(theta, x_test, x_train)
        return Kxs @ alpha, Kxs, solve_fn(L, Kxs.T)

    return predict
