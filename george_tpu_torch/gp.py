# -*- coding: utf-8 -*-
"""The Gaussian Process object (main-path subset).

API-compatible with george's GP for ``compute`` / ``log_likelihood`` /
``grad_log_likelihood`` plus the full modeling-protocol parameter surface
and the dirty-flag recompute contract.  The full parameter vector is laid
out [mean | white-noise | kernel].  Prediction and sampling follow in a
later slice.

For the sampler-facing functional interface see
:func:`george_tpu_torch.samplers.build_gp_log_prob`.
"""

import numpy as np
import torch
from scipy.linalg import LinAlgError

from . import kernels
from ._device import resolve_device
from .modeling import ModelSet, ConstantModel
from .solvers.basic import BasicSolver, build_covariance, cholesky_logdet

__all__ = ["GP"]

# Default log white-noise variance (george's jitter).
TINY = 1.25e-12


def _parse_model(model):
    try:
        value = float(model)
    except TypeError:
        return model
    return ConstantModel(value)


def _is_scalar(value):
    try:
        float(value)
    except TypeError:
        return False
    return value is not None


class GP(ModelSet):
    """The basic Gaussian Process regression object.

    :param kernel: a :class:`kernels.Kernel` (default: EmptyKernel).
    :param fit_kernel: include kernel parameters in the active set.
    :param mean: scalar, callable, or modeling-protocol object for the mean
        function (default 0).
    :param fit_mean: include mean parameters in the active set.
    :param white_noise: scalar or model for the *log* of the white noise
        variance added to the diagonal (default log(TINY)).
    :param fit_white_noise: include white-noise parameters in the active set.
    :param device: where the dense factorization runs (default: the CUDA
        card; raises without one unless ``device="cpu"`` is given).
    :param dtype: the factorization's floating type (default float64).
    """

    def __init__(self, kernel=None, fit_kernel=True, mean=None,
                 fit_mean=None, white_noise=None, fit_white_noise=None,
                 device=None, dtype=torch.float64):
        self.device = resolve_device(device)
        self.dtype = dtype
        self._computed = False
        self.solver = None

        super(GP, self).__init__([
            ("mean",
             ConstantModel(0.0) if mean is None else _parse_model(mean)),
            ("white_noise",
             ConstantModel(np.log(TINY)) if white_noise is None
             else _parse_model(white_noise)),
            ("kernel",
             kernels.EmptyKernel() if kernel is None else kernel),
        ])

        # A bare scalar mean / white noise is not fit unless asked.
        if _is_scalar(mean):
            fit_mean = bool(fit_mean)
        if _is_scalar(white_noise):
            fit_white_noise = bool(fit_white_noise)

        # Freeze whatever the caller did not ask to fit; an absent model is
        # always frozen regardless of the flag.
        def off(flag):
            return flag is not None and not flag

        frozen = {
            "kernel": not fit_kernel,
            "mean": mean is None or off(fit_mean),
            "white_noise": white_noise is None or off(fit_white_noise),
        }
        for name, freeze in frozen.items():
            if freeze:
                self.models[name].freeze_all_parameters()

    # -- component access -------------------------------------------------------

    @property
    def mean(self):
        """The mean-function model."""
        return self.models["mean"]

    @property
    def white_noise(self):
        """The log-white-noise-variance model."""
        return self.models["white_noise"]

    @staticmethod
    def _model_input(x):
        return x[:, 0] if (x.ndim == 2 and x.shape[1] == 1) else x

    def _call_mean(self, x):
        mu = np.asarray(self.mean.get_value(self._model_input(x))).flatten()
        if not np.all(np.isfinite(mu)):
            raise ValueError(
                "mean function returned NaN or Inf for parameters:\n"
                "{0}".format(self.mean.get_parameter_dict(include_frozen=True))
            )
        return np.broadcast_to(mu, (x.shape[0],))

    def _call_white_noise(self, x):
        wn = np.asarray(self.white_noise.get_value(self._model_input(x)))
        return np.broadcast_to(wn.flatten(), (x.shape[0],))

    # -- computed state -----------------------------------------------------------

    @property
    def computed(self):
        """True if the factorization is current w.r.t. the parameters."""
        return (
            self._computed
            and self.solver is not None
            and self.solver.computed
            and not self.kernel.dirty
        )

    @computed.setter
    def computed(self, v):
        self._computed = v
        if v:
            self.kernel.dirty = False

    def parse_samples(self, t):
        """Coerce inputs to a C-contiguous f64 (nsamples, ndim) array."""
        t = np.ascontiguousarray(t, dtype=np.float64)
        if t.ndim == 0:
            t = t[None]
        if t.ndim == 1:
            t = t[:, None]
        if t.ndim != 2 or t.shape[1] != self.kernel.ndim:
            raise ValueError("Dimension mismatch")
        return t

    def _check_dimensions(self, y):
        y = np.atleast_1d(y)
        if y.ndim > 1:
            raise ValueError("The predicted dimension must be 1-D")
        if len(y) != self._x.shape[0]:
            raise ValueError("Dimension mismatch")
        return y

    def _residual(self, y):
        """Mean-subtracted observations as a fresh f64 vector."""
        r = self._check_dimensions(y) - self._call_mean(self._x)
        return np.ascontiguousarray(r, dtype=np.float64)

    def _tensor(self, a):
        return torch.as_tensor(np.array(a, dtype=np.float64),
                               device=self.device).to(self.dtype)

    # -- factorization ---------------------------------------------------------------

    def compute(self, x, yerr=0.0):
        """Factorize K(x, x) + diag(yerr^2 + exp(white_noise))."""
        self._x = self.parse_samples(x)
        n = self._x.shape[0]
        yerr = np.asarray(yerr, dtype=np.float64)
        if yerr.ndim:
            yerr = self._check_dimensions(yerr)
        self._yerr2 = np.ascontiguousarray(
            np.broadcast_to(yerr, (n,)) ** 2, dtype=np.float64
        )
        noise = self._yerr2 + np.exp(self._call_white_noise(self._x))
        self.solver = BasicSolver(self.kernel, self.device, self.dtype)
        self.solver.compute(self._x, np.sqrt(noise))
        self._const = -0.5 * (
            n * np.log(2 * np.pi) + self.solver.log_determinant
        )
        self.computed = True

    def recompute(self, quiet=False):
        """Refactorize if the parameters changed since the last compute."""
        if not self.computed:
            if not (hasattr(self, "_x") and hasattr(self, "_yerr2")):
                raise RuntimeError("You need to compute the model first")
            try:
                self.compute(self._x, np.sqrt(self._yerr2))
            except (ValueError, LinAlgError):
                if quiet:
                    return False
                raise
        return True

    # -- likelihood ---------------------------------------------------------------------

    def log_likelihood(self, y, quiet=False):
        """Marginalized log-likelihood of ``y`` under the GP model."""
        if not self.recompute(quiet=quiet):
            return -np.inf
        y = self._check_dimensions(y)
        try:
            r = self._residual(y)
        except ValueError:
            if quiet:
                return -np.inf
            raise
        ll = self._const - 0.5 * self.solver.dot_solve(r)
        return ll if np.isfinite(ll) else -np.inf

    def grad_log_likelihood(self, y, quiet=False):
        """Gradient of the log-likelihood w.r.t. the active parameters.

        Ordering matches :meth:`get_parameter_vector`: mean, white noise,
        kernel.  Kernel and white-noise terms come from one autograd pass
        through the Cholesky; the mean term is the (d mu / d theta) @ alpha
        contraction.
        """
        if not self.recompute(quiet=quiet):
            return np.zeros(len(self), dtype=np.float64)
        y = self._check_dimensions(y)
        try:
            r_host = self._residual(y)
        except ValueError:
            if quiet:
                return np.zeros(len(self), dtype=np.float64)
            raise

        theta = self._tensor(
            self.kernel.get_parameter_vector(include_frozen=True)
        ).requires_grad_(True)
        wn_vec = self._tensor(
            self._call_white_noise(self._x)
        ).requires_grad_(True)
        r = self._tensor(r_host)
        K = build_covariance(self.kernel.spec_node(), theta,
                             self._tensor(self._x),
                             self._tensor(self._yerr2) + torch.exp(wn_vec))
        L, logdet = cholesky_logdet(K)
        alpha = torch.cholesky_solve(r[:, None], L)[:, 0]
        f = -0.5 * (logdet + torch.dot(r, alpha))
        g_theta, g_wn_vec = (
            g.cpu().numpy() for g in torch.autograd.grad(f, (theta, wn_vec))
        )
        alpha = alpha.detach().cpu().numpy()

        grad = np.empty(len(self))
        n = 0
        x_in = self._model_input(self._x)
        n_mean = len(self.mean)
        if n_mean:
            grad[n:n + n_mean] = np.dot(self.mean.get_gradient(x_in), alpha)
            n += n_mean
        n_wn = len(self.white_noise)
        if n_wn:
            wn_grad = np.atleast_2d(self.white_noise.get_gradient(x_in))
            grad[n:n + n_wn] = wn_grad @ g_wn_vec
            n += n_wn
        n_k = len(self.kernel)
        if n_k:
            grad[n:n + n_k] = g_theta[self.kernel.unfrozen_mask]
        return grad
