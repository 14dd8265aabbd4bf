# -*- coding: utf-8 -*-
"""Closed-form solver for the kernel-free (purely diagonal) GP.

When the GP carries no kernel the covariance is ``diag(yerr**2)`` and every
operation of the solver protocol is elementwise arithmetic against the
stored inverse variances.  Arrays come in and go out as numpy, tensors as
tensors on their own device.
"""

import numpy as np
import torch

from .basic import dense_grad_core

__all__ = ["TrivialSolver"]


class TrivialSolver(object):
    """Diagonal-covariance solver used when the GP has an EmptyKernel.

    ``device`` and ``dtype`` are accepted for the GP's solver protocol; the
    arithmetic runs on the host.
    """

    def __init__(self, kernel=None, device=None, dtype=torch.float64):
        from ..kernels import EmptyKernel

        if kernel is not None and \
                kernel.kernel_type != EmptyKernel.kernel_type:
            raise ValueError(
                "TrivialSolver only handles the diagonal (no-kernel) case")
        self._ivar = None

    @property
    def computed(self):
        return self._ivar is not None

    @property
    def log_determinant(self):
        # log det diag(sigma^2) = -sum log(1/sigma^2)
        if self._ivar is None:
            return None
        return -float(np.sum(np.log(self._ivar)))

    def compute(self, x, yerr):
        self._ivar = np.asarray(yerr, dtype=np.float64) ** -2

    def apply_inverse(self, y, in_place=False):
        if torch.is_tensor(y):
            ivar = torch.as_tensor(self._ivar, device=y.device).to(y.dtype)
            return y * (ivar if y.dim() == 1 else ivar[:, None])
        out = y if in_place else np.array(y, dtype=np.float64)
        out *= self._ivar if out.ndim == 1 else self._ivar[:, None]
        return out

    def dot_solve(self, y):
        y = np.asarray(y)
        return float(np.dot(y * self._ivar, y))

    def apply_sqrt(self, r):
        return np.asarray(r) * np.sqrt(self._ivar)

    def grad_core(self, gp, r):
        """The GP's white-noise gradient (the kernel's is empty) and
        ``K^-1 r``; see :func:`~.basic.dense_grad_core`."""
        return dense_grad_core(gp, r)

    def get_inverse(self):
        return np.diag(self._ivar)
