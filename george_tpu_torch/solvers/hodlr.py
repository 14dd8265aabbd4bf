# -*- coding: utf-8 -*-
"""Hierarchical (HODLR) solver over the level-batched factorization.

george's HODLRSolver API: the constructor's ``min_size=100, tol=0.1,
seed=42``, the solver protocol, ``apply_sqrt`` unsupported, and pickling
that drops the device-side factorization.  The factorization is
:mod:`george_tpu_torch.ops.hodlr_core`'s, on the solver's device in its
dtype.  Arrays come in and go out as numpy, tensors as tensors on the
solver's device.
"""

import numpy as np
import torch

from ..ops import hodlr_core
from .basic import BasicSolver

__all__ = ["HODLRSolver"]


class HODLRSolver(BasicSolver):
    """O(N log^2 N) solver via hierarchical off-diagonal low-rank compression.

    :param kernel: the kernel instance.
    :param min_size: leaf switch-over size for the recursion (default 100).
    :param tol: Frobenius-norm tolerance of the blockwise low-rank
        approximation (default 0.1).
    :param seed: accepted for reference API parity; the batched ACA is
        deterministic.
    :param max_rank: optional hard cap on the per-block rank (defaults to a
        cap derived from ``tol``).
    :param order: internal point ordering: ``"auto"`` (default; recursive
        KD median splits, which make off-diagonal blocks low-rank for
        multi-dimensional or unsorted inputs), ``"kd"``, ``"hilbert"``,
        ``"distance"`` (the reference's nd_sort_samples), or ``None`` to
        factor in the caller's order.  The permutation is applied and
        undone internally.
    :param device, dtype: where the factorization lives (default: the CUDA
        card, float64).
    """

    def __init__(self, kernel, min_size=100, tol=0.1, seed=42,
                 max_rank=None, order="auto", device=None,
                 dtype=torch.float64):
        self.min_size = min_size
        self.tol = tol
        self.seed = seed
        self.max_rank = max_rank
        self.order = order
        self._fact = None
        self._perm = None
        self._inv_perm = None
        super(HODLRSolver, self).__init__(kernel, device=device, dtype=dtype)

    def _ordering(self, x):
        from .. import utils

        order = "kd" if self.order == "auto" else self.order
        if order in (None, "none"):
            return None
        fn = {
            "kd": utils.kd_sort_samples,
            "hilbert": utils.hilbert_sort_samples,
            "distance": utils.nd_sort_samples,
        }[order]
        perm = np.asarray(fn(x))
        if np.array_equal(perm, np.arange(x.shape[0])):
            return None
        return perm

    def compute(self, x, yerr):
        x = np.ascontiguousarray(np.atleast_2d(x), dtype=np.float64)
        if x.shape[0] == 1 and x.shape[1] != self.kernel.ndim:
            x = x.T
        diag_noise = np.broadcast_to(
            np.asarray(yerr, dtype=np.float64) ** 2, (x.shape[0],))
        self._perm = self._ordering(x)
        self._inv_perm = None
        if self._perm is not None:
            x = x[self._perm]
            diag_noise = diag_noise[self._perm]
            self._inv_perm = np.argsort(self._perm)
        self._fact = hodlr_core.hodlr_compute(
            self.kernel.spec_node(),
            self.kernel.get_parameter_vector(include_frozen=True), x,
            diag_noise, min_size=self.min_size, tol=self.tol, seed=self.seed,
            max_rank=self.max_rank, device=self.device, dtype=self.dtype)
        self._x_sorted = x
        self._log_det = self._fact.log_determinant
        self.computed = True

    def _sorted(self, y):
        """Rows of ``y`` in the internal order (numpy or tensor)."""
        if self._perm is None:
            return y
        if torch.is_tensor(y):
            return y[torch.as_tensor(self._perm, device=y.device)]
        return np.asarray(y)[self._perm]

    def _unsorted(self, out):
        if self._perm is None:
            return out
        return out[torch.as_tensor(self._inv_perm, device=out.device)]

    def grad_core(self, gp, r):
        """``(g_theta, g_wn, alpha)`` of the GP for the residual ``r``
        (caller's order): one backward pass through the level sweeps
        (``ops/hodlr_core.hodlr_grad_core``), never an N x N matrix.  The
        white-noise gradient comes back projected onto its model's active
        parameters."""
        wn_vec = gp._call_white_noise(gp._x)
        yerr2 = gp._yerr2
        wn_dirs = None
        if len(gp.white_noise):
            wn_dirs = np.atleast_2d(
                gp.white_noise.get_gradient(gp._model_input(gp._x)))
        if self._perm is not None:
            wn_vec, r, yerr2 = (np.asarray(a)[self._perm]
                                for a in (wn_vec, r, yerr2))
            if wn_dirs is not None:
                wn_dirs = wn_dirs[:, self._perm]
        g_theta, g_wn, alpha = hodlr_core.hodlr_grad_core(
            self.kernel.spec_node(), self._fact,
            self.kernel.get_parameter_vector(include_frozen=True), wn_vec,
            self._x_sorted, r, yerr2, self.tol, wn_dirs=wn_dirs,
            theta_idx=tuple(np.flatnonzero(self.kernel.unfrozen_mask)))
        return (gp._host(g_theta), gp._host(g_wn),
                gp._host(self._unsorted(alpha)))

    def apply_inverse(self, y, in_place=False):
        """Solve K x = y for a vector (N,) or a matrix (N, K); with
        ``in_place`` a numpy ``y`` of the result's shape is overwritten and
        returned.  A tensor ``y`` gives a tensor on the solver's device."""
        out = self._unsorted(hodlr_core.hodlr_solve(self._fact,
                                                    self._sorted(y)))
        if torch.is_tensor(y):
            return out
        out = out.cpu().numpy().astype(np.float64)
        if in_place and isinstance(y, np.ndarray) and y.shape == out.shape:
            y[...] = out
            return y
        return out

    def dot_solve(self, y):
        """y^T K^-1 y (permutation-invariant): a float for a vector, a
        (K, K) array for a matrix."""
        y = self._sorted(np.asarray(y, dtype=np.float64))
        if y.ndim <= 1:
            return float(hodlr_core.hodlr_dot_solve(self._fact, y))
        out = (self._tensor(y).T @ hodlr_core.hodlr_solve(self._fact, y))
        return out.cpu().numpy().astype(np.float64)

    def apply_sqrt(self, r):
        raise NotImplementedError(
            "apply_sqrt is not implemented for the HODLRSolver")

    def get_inverse(self):
        # apply_inverse handles the internal permutation: K^-1 = K^-1 @ I.
        return self.apply_inverse(np.eye(self._fact.n))

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_computed"] = False
        for key in ("_fact", "_perm", "_inv_perm", "_x_sorted"):
            state.pop(key, None)
        return state

    def __setstate__(self, state):
        state.setdefault("_fact", None)
        state.setdefault("_perm", None)
        state.setdefault("_inv_perm", None)
        self.__dict__.update(state)
