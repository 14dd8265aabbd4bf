# -*- coding: utf-8 -*-
"""O(N) state-space solver for 1-D Markovian kernels.

For ``Exp`` / ``Matern32`` / ``Matern52`` / ``Cosine`` / ``Constant``
kernels (and sums and constant scalings of them) on 1-D inputs the GP is an
exact linear-Gaussian state-space model, and every operation of the solver
protocol reduces to Kalman passes (``ops/state_space.py``):

  * ``log_determinant`` — the sum of the innovation variances' logs;
  * ``dot_solve``       — the sum of innov^2 / S from the filter;
  * ``apply_inverse``   — the regression identity ``K^-1 y = (y - h^T
    m^s) / v`` through the smoother, per column;
  * ``apply_sqrt``      — the innovations square root (the time-ordered
    Cholesky factorization the filter computes implicitly), so
    ``GP.sample`` is O(N) too.

``compute`` runs the data-free part of the filter once (innovation
variances, gains and smoother gains, by the associative-scan filter at
O(log N) depth); each column of data then takes affine scans only.
Inputs need not be sorted: the solver orders them and puts results back in
the caller's order.  Arrays come in and go out as numpy, tensors as tensors
on the solver's device.
"""

import numpy as np
import torch
from scipy.linalg import LinAlgError

from .._device import resolve_device
from ..modeling import ConstantModel
from ..ops import kalman
from ..ops import state_space as sskf
from .basic import project_white_noise

__all__ = ["StateSpaceSolver"]


class StateSpaceSolver(object):

    def __init__(self, kernel, device=None, dtype=torch.float64):
        if not sskf.supports_state_space(kernel.spec_node()):
            raise ValueError(
                "StateSpaceSolver requires a 1-D Markovian kernel "
                "(Exp/Matern32/Matern52/Cosine/Constant sums); got an "
                "unsupported kernel tree"
            )
        self.kernel = kernel
        self.device = resolve_device(device)
        self.dtype = dtype
        self._computed = False
        self._log_det = None
        self._factor = None
        self._t = None
        self._v = None
        self._order = None
        self._inv_order = None

    def __getstate__(self):
        # The device-side filter quantities are not pickled; a loaded
        # solver reads as not computed, and the GP recomputes it.
        state = self.__dict__.copy()
        state["_factor"] = None
        state["_computed"] = False
        return state

    @property
    def computed(self):
        return self._computed

    @computed.setter
    def computed(self, v):
        self._computed = v

    @property
    def log_determinant(self):
        return self._log_det

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=self.device).to(self.dtype)

    def compute(self, x, yerr):
        x = np.ascontiguousarray(x, dtype=np.float64)
        if x.ndim == 2:
            if x.shape[1] != 1:
                raise ValueError("StateSpaceSolver requires 1-D inputs")
            x = x[:, 0]
        v = np.broadcast_to(np.asarray(yerr, dtype=np.float64) ** 2, x.shape)
        if not np.all(v > 0):
            raise ValueError(
                "StateSpaceSolver needs strictly positive yerr (the "
                "smoother-based solve divides by the noise variance)"
            )
        order = np.argsort(x, kind="stable")
        self._order = order
        self._inv_order = np.argsort(order)
        self._t = np.ascontiguousarray(x[order])
        self._v = np.ascontiguousarray(v[order])
        theta = self._tensor(self.kernel.get_parameter_vector(
            include_frozen=True))
        # Gaps in float64 before the cast (the inputs may be large epochs).
        with torch.no_grad():
            self._factor = sskf.StateSpaceFactor(
                sskf.extract_terms(self.kernel.spec_node()), theta,
                self._tensor(np.diff(self._t)), self._tensor(self._v))
            logdet = float(self._factor.log_determinant)
        if not np.isfinite(logdet):
            raise LinAlgError("state-space factorization failed")
        self._log_det = logdet
        self.computed = True

    def _sorted(self, y):
        """Rows of ``y`` in time order, as a tensor on the device."""
        if torch.is_tensor(y):
            order = torch.as_tensor(self._order, device=y.device)
            return y.to(self.device, self.dtype)[order]
        return self._tensor(np.asarray(y, dtype=np.float64)[self._order])

    def dot_solve(self, y):
        with torch.no_grad():
            return float(self._factor.dot_solve(self._sorted(y)))

    def apply_inverse(self, y, in_place=False):
        with torch.no_grad():
            out = self._factor.apply_inverse(self._sorted(y))
        out = out[torch.as_tensor(self._inv_order, device=out.device)]
        if torch.is_tensor(y):
            return out
        out = out.cpu().numpy().astype(np.float64)
        if in_place and isinstance(y, np.ndarray) and y.shape == out.shape:
            y[...] = out
            return y
        return out

    def apply_sqrt(self, r):
        """Map iid normals ``r`` (..., N) to draws with covariance
        K + diag(v), O(N).

        The square root is the innovations one (time-ordered): the rows of
        the result have exactly the computed covariance, as the dense
        solver's ``r @ L^T`` do, through a different factor.
        """
        with torch.no_grad():
            out = self._factor.apply_sqrt(self._tensor(r))
        return out.cpu().numpy().astype(np.float64)[..., self._inv_order]

    def grad_core(self, gp, r):
        """``(g_theta, g_wn, alpha)`` of the GP for the residual ``r``
        (caller's order): the O(N) counterpart of the dense solvers'.

        Routing by the white-noise model: where it is a ``ConstantModel``
        (one scalar log white noise, the default), the kernel and
        white-noise gradient is the Kalman value+gradient at B = 1
        (``ops/kalman.make_kalman_vg`` with no mean parameter and ``r`` as
        the data): on the card one launch of ``csrc/kalman_vg.cu``, which
        raises if it cannot build or launch; on the CPU its plain version.
        A white-noise model that varies with x takes autograd through the
        associative-scan filter (``ops/state_space.state_space_grad_core_fn``),
        whose per-point gradient is projected onto the model's parameters.
        ``alpha = K^-1 r`` comes from the smoother.
        """
        node = self.kernel.spec_node()
        theta = self.kernel.get_parameter_vector(include_frozen=True)
        wn = gp.white_noise
        if not (isinstance(wn, ConstantModel) and wn.full_size == 1):
            core = sskf.state_space_grad_core_fn(node)
            order = self._order
            g_theta, g_wn, alpha = (gp._host(v) for v in core(
                gp._tensor(theta),
                gp._tensor(gp._call_white_noise(gp._x)[order]),
                gp._tensor(self._t), gp._tensor(r[order]),
                gp._tensor(gp._yerr2[order])))
            inv = self._inv_order
            return g_theta, project_white_noise(gp, g_wn[inv]), alpha[inv]

        alpha = self.apply_inverse(r)
        kernel_active = np.flatnonzero(self.kernel.unfrozen_mask)
        n_wn = len(wn)
        active = tuple(range(n_wn)) + tuple(int(i) + 1 for i in kernel_active)
        g_theta = np.zeros(len(theta))
        g_wn = np.zeros(n_wn)
        if active:
            vg = kalman.make_kalman_vg(node, self._t, r[self._order],
                                       gp._yerr2[self._order], 0, 1, active)
            theta_full = gp._tensor(np.concatenate(
                [wn.get_parameter_vector(include_frozen=True), theta]))
            _, g = vg(theta_full[None])
            g = gp._host(g[0])
            g_wn[:] = g[:n_wn]
            g_theta[kernel_active] = g[n_wn:]
        return g_theta, g_wn, alpha

    def get_inverse(self):
        return self.apply_inverse(np.eye(self._t.shape[0]))
