# -*- coding: utf-8 -*-
"""The Gaussian Process object.

API-compatible with george's GP: ``compute`` / ``log_likelihood`` /
``grad_log_likelihood`` / ``predict`` / ``sample`` / ``sample_conditional``
/ ``apply_inverse`` / ``get_matrix`` / ``nll`` / ``grad_nll``, the full
modeling-protocol parameter surface, the dirty-flag recompute contract and
the alpha cache keyed on the value of ``y``.  The full parameter vector is
laid out [mean | white-noise | kernel].

Everything runs on the GP's device in its dtype (default: the CUDA card,
float64); arrays come in and go out as numpy.  The solver is george's
choice: ``TrivialSolver`` for an absent or empty kernel, ``BasicSolver``
(dense Cholesky) otherwise, or the one passed as ``solver=``, e.g.
``HODLRSolver`` (O(N log^2 N), approximate) or ``StateSpaceSolver`` (O(N),
1-D Markovian kernels).  On the card, large
stationary covariance builds (``compute``, the gradient, the cross and
prior matrices of ``predict``) go through the tiled kernel of
``ops/cov.py`` under ``config.pallas_covariance``, and the state-space
solver's likelihood gradient is one launch of the Kalman value+gradient
kernel (``ops/kalman.py``).  A pickled GP carries host arrays, its device
and its dtype.  The one deliberate
difference of API: ``sample`` and ``sample_conditional`` draw from a
``torch.Generator`` (default: a fresh one) where the JAX package used the
global ``np.random``.

For the sampler-facing functional interface see
:func:`george_tpu_torch.samplers.build_gp_log_prob`.
"""

import warnings

import numpy as np
import torch
from scipy.linalg import LinAlgError

from . import kernels
from ._device import resolve_device
from .dsl import compiler
from .modeling import ModelSet, ConstantModel
from .ops import linalg
from .solvers import TrivialSolver, BasicSolver
from .utils import multivariate_gaussian_samples, standard_normal

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


def _deprecated(old, new):
    # stacklevel=3: attribute the warning to the caller of the deprecated
    # method, not this helper.
    warnings.warn("'{0}' is deprecated. Use '{1}'".format(old, new),
                  DeprecationWarning, stacklevel=3)


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
    :param solver: solver class (``TrivialSolver`` / ``BasicSolver`` /
        ``HODLRSolver`` / ``StateSpaceSolver``; default ``TrivialSolver``
        for an absent or empty kernel, ``BasicSolver`` otherwise).
    :param device: where the solver runs (default: the CUDA card; raises
        without one unless ``device="cpu"`` is given).
    :param dtype: the solver's floating type (default float64).
    :param kwargs: forwarded to the solver's constructor.
    """

    def __init__(self, kernel=None, fit_kernel=True, mean=None,
                 fit_mean=None, white_noise=None, fit_white_noise=None,
                 solver=None, device=None, dtype=torch.float64, **kwargs):
        self.device = resolve_device(device)
        self.dtype = dtype
        self._computed = False
        self._alpha = None
        self._y = None
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

        if solver is None:
            # An absent or empty kernel needs only the diagonal solver.
            empty = kernels.EmptyKernel.kernel_type
            solver = TrivialSolver if kernel is None \
                or kernel.kernel_type == empty else BasicSolver
        self.solver_type = solver
        self.solver_kwargs = dict(kwargs)

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

    def _call_mean_gradient(self, x):
        mu = self.mean.get_gradient(self._model_input(x))
        if np.any(np.isnan(mu)) or np.any(np.isinf(mu)):
            raise ValueError(
                "mean gradient function returned NaN or Inf for parameters:"
                "\n{0}".format(
                    self.mean.get_parameter_dict(include_frozen=True))
            )
        return mu

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

    def _check_dimensions(self, y, check_dim=True):
        y = np.atleast_1d(y)
        if check_dim and y.ndim > 1:
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

    @staticmethod
    def _host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    def _compute_alpha(self, y, cache):
        """K^-1 (y - mu), optionally cached on the value of ``y``."""
        if not cache:
            return self.solver.apply_inverse(self._residual(y),
                                             in_place=True).ravel()
        if self._alpha is None or not np.array_equiv(y, self._y):
            self._y = y
            self._alpha = self.solver.apply_inverse(
                self._residual(y), in_place=True).ravel()
        return self._alpha

    # -- factorization ---------------------------------------------------------------

    def compute(self, x, yerr=0.0, **kwargs):
        """Factorize K(x, x) + diag(yerr^2 + exp(white_noise)); ``kwargs``
        go to the solver's ``compute``."""
        self._x = self.parse_samples(x)
        n = self._x.shape[0]
        yerr = np.asarray(yerr, dtype=np.float64)
        if yerr.ndim:
            yerr = self._check_dimensions(yerr)
        self._yerr2 = np.ascontiguousarray(
            np.broadcast_to(yerr, (n,)) ** 2, dtype=np.float64
        )
        noise = self._yerr2 + np.exp(self._call_white_noise(self._x))
        self.solver = self.solver_type(self.kernel, device=self.device,
                                       dtype=self.dtype, **self.solver_kwargs)
        self.solver.compute(self._x, np.sqrt(noise), **kwargs)
        self._const = -0.5 * (
            n * np.log(2 * np.pi) + self.solver.log_determinant
        )
        self.computed = True
        self._alpha = None

    def recompute(self, quiet=False, **kwargs):
        """Refactorize if the parameters changed since the last compute
        (``kwargs`` as for :meth:`compute`)."""
        if not self.computed:
            if not (hasattr(self, "_x") and hasattr(self, "_yerr2")):
                raise RuntimeError("You need to compute the model first")
            try:
                self.compute(self._x, np.sqrt(self._yerr2), **kwargs)
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
        kernel.  Kernel and white-noise terms come from the solver's
        ``grad_core`` (the dense solvers: one autograd pass through the
        Cholesky; the state-space solver: the Kalman value+gradient
        kernel or the scan filter); the mean term is the
        (d mu / d theta) @ alpha contraction.
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

        g_theta, g_wn, alpha = self.solver.grad_core(self, r_host)

        grad = np.empty(len(self))
        n = 0
        n_mean = len(self.mean)
        if n_mean:
            try:
                mu_grad = self._call_mean_gradient(self._x)
            except ValueError:
                if quiet:
                    return np.zeros(len(self), dtype=np.float64)
                raise
            grad[n:n + n_mean] = np.dot(mu_grad, alpha)
            n += n_mean
        n_wn = len(self.white_noise)
        if n_wn:
            grad[n:n + n_wn] = g_wn
            n += n_wn
        n_k = len(self.kernel)
        if n_k:
            grad[n:n + n_k] = g_theta[self.kernel.unfrozen_mask]
        return grad

    def lnlikelihood(self, y, quiet=False):
        _deprecated("lnlikelihood", "log_likelihood")
        return self.log_likelihood(y, quiet=quiet)

    def grad_lnlikelihood(self, y, quiet=False):
        _deprecated("grad_lnlikelihood", "grad_log_likelihood")
        return self.grad_log_likelihood(y, quiet=quiet)

    def nll(self, vector, y, quiet=True):
        """Negative log-likelihood at ``vector`` (for scipy optimizers)."""
        self.set_parameter_vector(vector)
        if not np.isfinite(self.log_prior()):
            return np.inf
        return -self.log_likelihood(y, quiet=quiet)

    def grad_nll(self, vector, y, quiet=True):
        """Gradient of :meth:`nll` at ``vector``."""
        self.set_parameter_vector(vector)
        if not np.isfinite(self.log_prior()):
            return np.zeros(len(vector))
        return -self.grad_log_likelihood(y, quiet=quiet)

    # -- prediction --------------------------------------------------------------

    def apply_inverse(self, y):
        """Apply K^-1 (with the mean subtracted) to a vector or matrix.

        Multi-RHS inputs of shape (N, K) are handled column-wise; the mean
        is broadcast down the leading (data) axis.
        """
        self.recompute(quiet=False)
        r = self._check_dimensions(
            np.array(y, dtype=np.float64, order="F"), check_dim=False
        )
        mu = self._call_mean(self._x)
        r -= mu.reshape(mu.shape + (1,) * (r.ndim - 1))
        out = self.solver.apply_inverse(r, in_place=True)
        return out.ravel() if r.ndim == 1 else out

    def _matrix(self, kernel, x1, x2=None, diag=False):
        """A covariance block as a tensor on the GP's device, in its
        dtype."""
        return kernel.value_tensor(x1, x2, diag=diag, device=self.device,
                                   dtype=self.dtype)

    def predict(self, y, t, return_cov=True, return_var=False, cache=True,
                kernel=None):
        """Conditional predictive distribution at test points ``t``.

        Returns ``mu``, ``(mu, cov)``, or ``(mu, var)`` depending on
        ``return_cov`` / ``return_var``.  Passing ``kernel=`` computes the
        cross terms with a different kernel (for separating the predictions
        of kernel mixtures).
        """
        self.recompute()
        xs = self.parse_samples(t)
        cross = self.kernel if kernel is None else kernel

        a = self._tensor(self._compute_alpha(y, cache))
        Ks = self._matrix(cross, xs, self._x)          # (M, N) cross-cov
        mean_pred = self._host(Ks @ a) + self._call_mean(xs)
        if not (return_cov or return_var):
            return mean_pred

        # One multi-RHS solve W = K^-1 Ks^T serves both output forms.
        W = self.solver.apply_inverse(Ks.T)
        if return_var:
            diag_prior = self._matrix(cross, xs, diag=True)
            return mean_pred, self._host(
                diag_prior - torch.sum(Ks * W.T, dim=1))
        return mean_pred, self._host(self._matrix(cross, xs) - Ks @ W)

    def predictor(self, y):
        """A repeated-prediction closure for fixed training data.

        Returns ``f(t, return_var=True) -> (mu, var)`` over the current
        factorization and alpha, with the cross-covariance, solve and
        variance computed on the GP's device.  Needs a dense factor
        (``BasicSolver``).
        """
        self.recompute()
        alpha = self._tensor(self._compute_alpha(y, True))
        L = getattr(self.solver, "factor", None)
        if L is None:
            raise NotImplementedError(
                "predictor() requires a dense-factor solver")
        node = self.kernel.spec_node()
        theta = self._tensor(self.kernel.get_parameter_vector(
            include_frozen=True))
        x_train = self._tensor(self._x)
        value = linalg.predict_fn(node)
        diag_fn = compiler.kernel_diag_fn(node)

        def predict_fast(t, return_var=True):
            xs_host = self.parse_samples(t)
            xs = self._tensor(xs_host)
            with torch.no_grad():
                mu, Kxs, KinvKxs = value(theta, x_train, L, alpha, xs)
                mu = self._host(mu) + self._call_mean(xs_host)
                if not return_var:
                    return mu
                var = diag_fn(theta, xs, xs) - torch.sum(Kxs * KinvKxs.T,
                                                         dim=1)
            return mu, self._host(var)

        return predict_fast

    def sample_conditional(self, y, t, size=1, generator=None):
        """Draw samples from the predictive conditional distribution."""
        mu, cov = self.predict(y, t)
        return multivariate_gaussian_samples(cov, size, mean=mu,
                                             generator=generator)

    def sample(self, t=None, size=1, generator=None):
        """Draw samples from the GP prior (``generator``: a
        ``torch.Generator``, default a freshly seeded one)."""
        if t is None:
            # Ride the computed factorization: draws = mean + z L^T.
            self.recompute()
            z = standard_normal((size, self._x.shape[0]), generator)
            draws = self.solver.apply_sqrt(z) + self._call_mean(self._x)
            return draws[0] if size == 1 else draws

        xs = self.parse_samples(t)
        cov = self.get_matrix(xs).astype(np.float64)
        cov.flat[:: len(cov) + 1] += TINY      # jitter the diagonal
        return multivariate_gaussian_samples(
            cov, size, mean=self._call_mean(xs), generator=generator
        )

    def get_matrix(self, x1, x2=None):
        """The bare covariance matrix at coordinates x1 (x cross x2), as
        numpy in the GP's dtype."""
        a = self.parse_samples(x1)
        b = None if x2 is None else self.parse_samples(x2)
        return self.kernel.get_value(a, b, device=self.device,
                                     dtype=self.dtype)

    # -- modeling-protocol synonyms ------------------------------------------------

    def get_value(self, *args, **kwargs):
        """Synonym for :meth:`log_likelihood` (modeling protocol)."""
        return self.log_likelihood(*args, **kwargs)

    def get_gradient(self, *args, **kwargs):
        """Synonym for :meth:`grad_log_likelihood` (modeling protocol)."""
        return self.grad_log_likelihood(*args, **kwargs)
