# -*- coding: utf-8 -*-
"""Dense Cholesky solver.

The API (compute / apply_inverse / dot_solve / apply_sqrt / get_inverse /
log_determinant / computed) is george's BasicSolver.  The covariance build
runs through the torch kernel evaluators (on the card, large stationary
builds through the tiled kernel of ``ops/cov.py``); the factorization is
``torch.linalg.cholesky_ex`` (cuSOLVER on the card), which the JAX package
likewise leaves to its compiler.  Arrays come in and go out as numpy,
tensors as tensors on the solver's device; :attr:`factor` is the lower
factor as a tensor there.  A pickled solver carries its factor as a host
array and puts it back on its device when loaded.
"""

import numpy as np
import torch
from scipy.linalg import LinAlgError

from .._device import resolve_device
from ..ops import linalg

__all__ = ["BasicSolver", "dense_grad_core", "project_white_noise"]


def project_white_noise(gp, g_wn):
    """The gradient of the GP's active white-noise parameters from the
    per-point gradient ``g_wn`` of the log white-noise variance."""
    if not len(gp.white_noise):
        return np.zeros(0)
    wn_grad = np.atleast_2d(
        gp.white_noise.get_gradient(gp._model_input(gp._x)))
    return wn_grad @ g_wn


def dense_grad_core(gp, r):
    """``(g_theta, g_wn, alpha)`` for the residual ``r``: one autograd pass
    through the Cholesky (``ops/linalg.grad_core_fn``), the white-noise
    gradient projected onto its model's active parameters."""
    core = linalg.grad_core_fn(gp.kernel.spec_node())
    g_theta, g_wn, alpha = (gp._host(v) for v in core(
        gp._tensor(gp.kernel.get_parameter_vector(include_frozen=True)),
        gp._tensor(gp._call_white_noise(gp._x)),
        gp._tensor(gp._x), gp._tensor(r), gp._tensor(gp._yerr2)))
    return g_theta, project_white_noise(gp, g_wn), alpha


class BasicSolver(object):

    def __init__(self, kernel, device=None, dtype=torch.float64):
        self.kernel = kernel
        self.device = resolve_device(device)
        self.dtype = dtype
        self._computed = False
        self._log_det = None
        self._factor = None

    def __getstate__(self):
        state = self.__dict__.copy()
        if self._factor is not None:
            state["_factor"] = self._factor.cpu().numpy()
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        if self._factor is not None:
            self._factor = torch.as_tensor(self._factor, device=self.device)

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
        returned.  A tensor ``y`` gives a tensor on the solver's device."""
        if torch.is_tensor(y):
            return linalg.solve_fn(self._factor,
                                   y.to(self.device, self.dtype))
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

    def grad_core(self, gp, r):
        """The GP's kernel and white-noise gradient and ``K^-1 r``; see
        :func:`dense_grad_core`."""
        return dense_grad_core(gp, r)

    def get_inverse(self):
        """The dense K^-1 (gradients and diagnostics only)."""
        return linalg.inverse_fn(self._factor).cpu().numpy() \
            .astype(np.float64)
