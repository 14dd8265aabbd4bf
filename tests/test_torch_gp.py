# -*- coding: utf-8 -*-
"""The port's GP API against the JAX package's GP, on the cases of
``tests/test_gp.py`` restricted to the basic solver.

Both run in float64 on the CPU (the port with ``device="cpu"``, JAX in x64,
``tests/conftest.py``); inputs are made with numpy from a seed and handed
to both, and parameters are carried across with
``convert.load_reference_parameters``.  Sampling is held to its
distribution: the draws' mean and covariance within Monte Carlo error.
"""

import warnings

import numpy as np
import pytest
import torch

import george_tpu
from george_tpu import kernels as jk

import george_tpu_torch
from george_tpu_torch import kernels as tk
from george_tpu_torch.convert import load_reference_parameters
from george_tpu_torch.ops import linalg
from george_tpu_torch.utils import check_gradient, numerical_gradient

RTOL = 1e-9


def _pair(make, **kw):
    """The same GP in both packages, the port's parameters loaded from the
    reference's."""
    gj = george_tpu.GP(make(jk), **kw)
    gt = george_tpu_torch.GP(make(tk), device="cpu", **kw)
    load_reference_parameters(
        gt, gj.get_parameter_names(include_frozen=True),
        gj.get_parameter_vector(include_frozen=True), gj.unfrozen_mask)
    return gj, gt


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("white_noise", [None, 0.1])
def test_gradient(white_noise, seed=123, N=305, ndim=3):
    rng = np.random.default_rng(seed)
    kw = {}
    if white_noise is not None:
        kw = dict(white_noise=white_noise, fit_white_noise=True)
    gj, gt = _pair(lambda k: 1.0 * k.ExpSquaredKernel(0.5, ndim=ndim), **kw)
    x = rng.random((N, ndim))
    x = x[np.argsort(x[:, 0])]
    y = np.sin(3 * x[:, 0]) + 0.1 * rng.standard_normal(N)
    for g in (gj, gt):
        g.compute(x, yerr=0.1)
    _close(gt.log_likelihood(y), gj.log_likelihood(y))
    grad = gt.grad_log_likelihood(y)
    _close(grad, gj.grad_log_likelihood(y), rtol=1e-8)
    # And against centered differences of the port's own likelihood.
    vector = gt.get_parameter_vector()
    fd = numerical_gradient(lambda v: gt.nll(v, y), vector.copy(),
                            dx=1.32e-3)
    gt.set_parameter_vector(vector)
    assert np.all(np.abs(-fd - grad) < 5 * 1.32e-3)
    _close(gt.nll(vector, y), -gj.log_likelihood(y))
    _close(gt.grad_nll(vector, y), -gj.grad_log_likelihood(y), rtol=1e-8)


def test_prediction(seed=42):
    rng = np.random.default_rng(seed)
    gj, gt = _pair(lambda k: k.ExpSquaredKernel(1.0), white_noise=0.0)
    x0 = np.linspace(-10, 10, 500)
    x = np.sort(rng.uniform(-10, 10, 300))
    y = np.sin(x)
    for g in (gj, gt):
        g.compute(x)
    mu, cov = gt.predict(y, x0)
    mu_j, cov_j = gj.predict(y, x0)
    _close(mu, mu_j, rtol=1e-8)
    _close(cov, cov_j, rtol=1e-8)
    _, var = gt.predict(y, x0, return_var=True)
    _close(var, gj.predict(y, x0, return_var=True)[1], rtol=1e-8)
    _close(var, np.diag(cov), rtol=1e-8)
    # The dense oracle of tests/test_gp.py.
    K = gt.get_matrix(x)
    K[np.diag_indices_from(K)] += 1.0
    _close(mu, gt.get_matrix(x0, x) @ np.linalg.solve(K, y), rtol=1e-8)
    _close(gt.get_matrix(x0, x), gj.get_matrix(x0, x))
    # The repeated-prediction closure.
    mu_f, var_f = gt.predictor(y)(x0)
    _close(mu_f, mu, rtol=1e-8)
    _close(var_f, var, rtol=1e-8)


def test_repeated_prediction_cache():
    gt = george_tpu_torch.GP(tk.ExpSquaredKernel(1.0), device="cpu")
    x = np.array((-1, 0, 1))
    gt.compute(x)
    t = np.array((-0.5, 0.3, 1.2))
    y = x / x.std()
    mu0, mu1 = (gt.predict(y, t, return_cov=False) for _ in range(2))
    assert np.array_equal(mu0, mu1)
    y2 = 2 * y
    mu2 = gt.predict(y2, t, return_cov=False)
    assert not np.array_equal(mu0, mu2)
    a0 = gt._alpha
    gt.kernel[0] += 0.1
    gt.recompute()
    gt._compute_alpha(y2, True)
    assert not np.allclose(a0, gt._alpha)
    mu, cov = gt.predict(y2, t)
    _, var = gt.predict(y2, t, return_var=True)
    assert np.allclose(np.diag(cov), var)


def test_apply_inverse(seed=1234, N=201, yerr=0.1):
    rng = np.random.default_rng(seed)
    gj, gt = _pair(lambda k: 1.0 * k.ExpSquaredKernel(0.5))
    x = np.sort(rng.random(N))
    for g in (gj, gt):
        g.compute(x, yerr=yerr)
    K = gt.get_matrix(x)
    K[np.diag_indices_from(K)] += yerr ** 2
    y = rng.standard_normal(N)
    b = gt.apply_inverse(y)
    _close(b, gj.apply_inverse(y), rtol=1e-7)
    np.testing.assert_allclose(b, np.linalg.solve(K, y), rtol=1e-6,
                               atol=1e-6 * np.abs(b).max())
    Y = rng.standard_normal((N, 5))
    B = gt.apply_inverse(Y)
    assert B.shape == (N, 5)
    _close(B, gj.apply_inverse(Y), rtol=1e-7)
    # The solver's matrix forms.
    S = gt.solver
    _close(S.dot_solve(Y), np.asarray(gj.solver.dot_solve(Y)), rtol=1e-7)
    _close(S.get_inverse() @ Y, B, rtol=1e-6)
    Z = rng.standard_normal((3, N))
    _close(S.apply_sqrt(Z), np.asarray(gj.solver.apply_sqrt(Z)))
    # The functional log-likelihood the GP's numbers must agree with.
    loglike = linalg.loglike_fn(gt.kernel.spec_node())
    noise = yerr ** 2 + np.exp(gt.white_noise.get_value(x)) * np.ones(N)
    ll = loglike(torch.as_tensor(gt.kernel.get_parameter_vector(
        include_frozen=True)), torch.as_tensor(x[:, None]),
        torch.as_tensor(y), torch.as_tensor(noise))
    _close(float(ll), gj.log_likelihood(y))


def test_predict_single(seed=1234, N=201, yerr=0.1):
    rng = np.random.default_rng(seed)
    gj, gt = _pair(lambda k: 1.0 * k.ExpSquaredKernel(0.5))
    x = np.sort(rng.random(N))
    y = np.sin(6 * x)
    for g in (gj, gt):
        g.compute(x, yerr=yerr)
    mu0, var0 = gt.predict(y, [0.0], return_var=True)
    mu, var = gt.predict(y, [0.0, 1.0], return_var=True)
    _, cov = gt.predict(y, [0.0, 1.0])
    assert np.allclose(mu0, mu[0]) and np.allclose(var0, var[0])
    assert np.allclose(var0, cov[0, 0])
    _close(mu, gj.predict(y, [0.0, 1.0], return_var=True)[0], rtol=1e-8)


def test_anchor_log_likelihood():
    # The published anchor (the reference's docs/tutorials/scaling.rst).
    x = np.sort(np.random.RandomState(1234).uniform(0, 10, 50000))
    yerr = 0.1 * np.ones_like(x)
    y = np.sin(x)
    gt = george_tpu_torch.GP(np.var(y) * tk.ExpSquaredKernel(1.0),
                             device="cpu")
    gt.compute(x[:100], yerr[:100])
    assert abs(gt.log_likelihood(y[:100]) - 133.946394912) < 1e-6


def test_quiet_failure_modes():
    gt = george_tpu_torch.GP(1.0 * tk.ExpSquaredKernel(1.0), device="cpu")
    x = np.linspace(0, 1, 10)
    gt.compute(x, 0.1)
    y = np.sin(x)
    assert np.isfinite(gt.log_likelihood(y))
    gt.set_parameter_vector([1e300, 1e300])
    assert gt.log_likelihood(y, quiet=True) == -np.inf
    assert np.all(gt.grad_log_likelihood(y, quiet=True) == 0.0)
    assert gt.nll(gt.get_parameter_vector(), y) == np.inf


def test_predict_kernel_mixture(seed=99, N=40):
    rng = np.random.default_rng(seed)
    gj, gt = _pair(lambda k: 1.0 * k.ExpSquaredKernel(1.0)
                   + 0.5 * k.CosineKernel(log_period=0.5))
    x = np.sort(rng.uniform(0, 8, N))
    y = np.sin(x)
    for g in (gj, gt):
        g.compute(x, 0.1)
    mu_full = gt.predict(y, x, return_cov=False)
    mu_1 = gt.predict(y, x, return_cov=False, kernel=gt.kernel.k1)
    mu_2 = gt.predict(y, x, return_cov=False, kernel=gt.kernel.k2)
    assert np.allclose(mu_1 + mu_2, mu_full)
    _close(mu_1, gj.predict(y, x, return_cov=False, kernel=gj.kernel.k1),
           rtol=1e-8)
    _, var_2 = gt.predict(y, x, return_var=True, kernel=gt.kernel.k2)
    _close(var_2, gj.predict(y, x, return_var=True, kernel=gj.kernel.k2)[1],
           rtol=1e-8)


def test_mean_model_gradient_and_deprecated_aliases(seed=5, N=60):
    rng = np.random.default_rng(seed)
    gj, gt = _pair(lambda k: 1.2 * k.Matern32Kernel(0.8), mean=0.3,
                   fit_mean=True, white_noise=np.log(1e-2),
                   fit_white_noise=True)
    x = np.sort(rng.uniform(0, 5, N))
    y = np.sin(x) + 0.1 * rng.standard_normal(N)
    for g in (gj, gt):
        g.compute(x, 0.1)
    _close(gt.grad_log_likelihood(y), gj.grad_log_likelihood(y), rtol=1e-8)
    check_gradient(gt, y, eps=1e-6)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ll = gt.lnlikelihood(y)
        gt.grad_lnlikelihood(y)
    assert ll == gt.log_likelihood(y)
    assert [w.category for w in caught] == [DeprecationWarning] * 2
    assert gt.get_value(y) == ll


def test_sampling_moments(N=6, draws=20000):
    """Prior and conditional draws: mean and covariance within Monte Carlo
    error, from a seeded generator (and reproducible with it)."""
    gt = george_tpu_torch.GP(1.0 * tk.ExpSquaredKernel(1.0), mean=0.5,
                             device="cpu")
    x = np.linspace(0, 3, N)
    y = np.sin(x)
    gt.compute(x, 0.2)

    def held(samples, mean, cov):
        emp_mean = samples.mean(0)
        se = np.sqrt(np.diag(cov) / len(samples))
        assert np.all(np.abs(emp_mean - mean) < 5 * se + 1e-12)
        emp_cov = np.cov(samples.T)
        # The sample covariance's standard error: sqrt((S_ii S_jj +
        # S_ij^2) / n) for Gaussian draws.
        d = np.diag(cov)
        se_cov = np.sqrt((np.outer(d, d) + cov ** 2) / len(samples))
        assert np.all(np.abs(emp_cov - cov) < 5 * se_cov + 1e-12)

    gen = torch.Generator().manual_seed(11)
    prior = gt.sample(x, size=draws, generator=gen)
    held(prior, 0.5 * np.ones(N), gt.get_matrix(x))
    again = gt.sample(x, size=draws, generator=torch.Generator()
                      .manual_seed(11))
    assert np.array_equal(prior, again)
    # Through the computed factorization: covariance K + diag(yerr^2).
    K = gt.get_matrix(x) + 0.04 * np.eye(N)
    held(gt.sample(size=draws, generator=gen), 0.5 * np.ones(N), K)
    t = np.array([0.5, 1.7, 2.9])
    mu, cov = gt.predict(y, t)
    cond = gt.sample_conditional(y, t, size=draws, generator=gen)
    held(cond, mu, cov)
    assert gt.sample(x, generator=gen).shape == (N,)
