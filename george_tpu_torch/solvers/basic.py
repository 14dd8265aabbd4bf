# -*- coding: utf-8 -*-
"""Dense Cholesky solver.

The API (compute / apply_inverse / dot_solve / log_determinant / computed)
is george's BasicSolver.  The covariance build runs through the torch kernel
evaluators; the factorization is ``torch.linalg.cholesky_ex`` (cuSOLVER on
the card), which the JAX package likewise leaves to its compiler.
"""

import numpy as np
import torch
from scipy.linalg import LinAlgError

from ..dsl import compiler

__all__ = ["BasicSolver", "build_covariance"]


def build_covariance(node, theta, x, diag_noise):
    """``K(x, x) + diag(diag_noise)`` as one (differentiable) tensor."""
    K = compiler.kernel_value_fn(node)(theta, x, x)
    return K + torch.diag(diag_noise)


def cholesky_logdet(K):
    """Lower Cholesky factor and log-determinant; raises if not PD."""
    L, info = torch.linalg.cholesky_ex(K)
    if int(info) != 0:
        raise LinAlgError("covariance matrix is not positive definite")
    return L, 2.0 * torch.sum(torch.log(torch.diagonal(L)))


class BasicSolver(object):

    def __init__(self, kernel, device, dtype=torch.float64):
        self.kernel = kernel
        self.device = device
        self.dtype = dtype
        self._computed = False
        self._log_det = None
        self._factor = None

    @property
    def computed(self):
        """True once :meth:`compute` has factorized the covariance."""
        return self._computed

    @computed.setter
    def computed(self, v):
        self._computed = v

    @property
    def log_determinant(self):
        return self._log_det

    def _tensor(self, a):
        return torch.as_tensor(np.array(a, dtype=np.float64),
                               device=self.device).to(self.dtype)

    def compute(self, x, yerr):
        """Build K(x, x) + diag(yerr^2) and factorize it."""
        x = self._tensor(x)
        diag_noise = np.broadcast_to(
            np.asarray(yerr, dtype=np.float64) ** 2, (x.shape[0],)
        )
        theta = self._tensor(self.kernel.get_parameter_vector(
            include_frozen=True
        ))
        with torch.no_grad():
            K = build_covariance(self.kernel.spec_node(), theta, x,
                                 self._tensor(diag_noise))
            L, logdet = cholesky_logdet(K)
        if not bool(torch.isfinite(logdet)):
            raise LinAlgError("covariance matrix is not positive definite")
        self._factor = L
        self._log_det = float(logdet)
        self.computed = True

    def apply_inverse(self, y):
        """Solve K x = y for a vector or (N, K) matrix y (numpy out)."""
        y = self._tensor(y)
        col = y[:, None] if y.ndim == 1 else y
        out = torch.cholesky_solve(col, self._factor)
        return (out[:, 0] if y.ndim == 1 else out).cpu().numpy()

    def dot_solve(self, y):
        """The inner product y^T K^{-1} y for a vector y."""
        y = self._tensor(y)
        z = torch.linalg.solve_triangular(self._factor, y[:, None],
                                          upper=False)
        return float(torch.sum(z * z))
