# -*- coding: utf-8 -*-
"""Dense Cholesky solver.

The API (compute / apply_inverse / dot_solve / apply_sqrt / get_inverse /
log_determinant / computed) is george's BasicSolver.  The covariance build
runs through the torch kernel evaluators (on the card, large stationary
builds through the tiled kernel of ``ops/cov.py``); the factorization is
``torch.linalg.cholesky_ex`` (cuSOLVER on the card), which the JAX package
likewise leaves to its compiler.  Arrays come in and go out as numpy;
:attr:`factor` is the lower factor as a tensor on the solver's device.
"""

import numpy as np
import torch
from scipy.linalg import LinAlgError

from ..ops import linalg

__all__ = ["BasicSolver"]


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

    @property
    def factor(self):
        """The lower Cholesky factor L (K = L L^T), a tensor."""
        return self._factor

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
            L, logdet = linalg.factor_fn(self.kernel.spec_node())(
                theta, x, self._tensor(diag_noise))
        # cholesky_ex reports failure through a NaN log-determinant; surface
        # it as the LinAlgError the GP's quiet=... contract expects.
        if not bool(torch.isfinite(logdet)):
            raise LinAlgError("covariance matrix is not positive definite")
        self._factor = L
        self._log_det = float(logdet)
        self.computed = True

    def apply_inverse(self, y, in_place=False):
        """Solve K x = y for a vector (N,) or a matrix (N, K); with
        ``in_place`` a numpy ``y`` of the result's shape is overwritten and
        returned."""
        out = linalg.solve_fn(self._factor, self._tensor(y)).cpu().numpy()
        if in_place and isinstance(y, np.ndarray) and y.shape == out.shape:
            y[...] = out
            return y
        return out.astype(np.float64)

    def dot_solve(self, y):
        """y^T K^-1 y: a float for a vector, a (K, K) array for a matrix."""
        out = linalg.dot_solve_fn(self._factor, self._tensor(y))
        return float(out) if out.dim() == 0 else out.cpu().numpy()

    def apply_sqrt(self, r):
        """Apply the Cholesky square root: ``r @ L^T`` (rows of r acquire
        covariance K)."""
        return linalg.apply_sqrt_fn(self._factor, self._tensor(r)) \
            .cpu().numpy().astype(np.float64)

    def get_inverse(self):
        """The dense K^-1 (gradients and diagnostics only)."""
        return linalg.inverse_fn(self._factor).cpu().numpy() \
            .astype(np.float64)
