# -*- coding: utf-8 -*-
"""The port's batched multi-restart L-BFGS against scipy.

The oracle is the JAX package's own (tests/test_optimize.py):
``scipy.optimize.minimize`` over the JAX GP's ``nll`` / ``grad_nll`` on the
same data, whose optimum the port's ``optimize.minimize`` must reach within
1e-8 relative, on the dense route and on the state-space route (where its
objective is the Kalman value+gradient's plain version, all restarts in
one batch).  The JAX package's optax program is not run here.

At most four test functions: pytest-xdist's ``--dist loadfile`` hands out
the files with more tests first, and this one is to come after the suite's
long files.
"""

import numpy as np
import pytest
import torch
from scipy.optimize import minimize as sp_minimize

import george_tpu
from george_tpu import kernels as jk

import george_tpu_torch
from george_tpu_torch import kernels as tk
from george_tpu_torch import optimize

# One intra-op thread: the tensors here are small, and the suite's workers
# run side by side.
torch.set_num_threads(1)


def _first_steps_data():
    rng = np.random.RandomState(1234)
    x = 10 * np.sort(rng.rand(15))
    yerr = 0.2 * np.ones_like(x)
    y = np.sin(x) + yerr * rng.randn(len(x))
    return x, y, yerr


def test_matches_scipy_oracle():
    x, y, yerr = _first_steps_data()
    for kernel, method in (("ExpSquaredKernel", "dense"),
                           ("Matern32Kernel", "dense"),
                           ("Matern32Kernel", "auto")):
        jgp = george_tpu.GP(np.var(y) * getattr(jk, kernel)(2.0))
        jgp.compute(x, yerr)
        p0 = jgp.get_parameter_vector()
        ref = sp_minimize(jgp.nll, p0, jac=jgp.grad_nll, args=(y,))
        gp = george_tpu_torch.GP(np.var(y) * getattr(tk, kernel)(2.0),
                                 device="cpu")
        gp.compute(x, yerr)
        res = optimize.minimize(gp, y, method=method, restarts=2,
                                device="cpu")
        assert res.success, (kernel, method, res)
        np.testing.assert_allclose(res.fun, ref.fun, rtol=1e-8)
        assert res.evaluations > res.nit > 0
        assert res.restart_x0.shape == (3, len(p0))
        np.testing.assert_array_equal(res.restart_x0[0], p0)
        # set_params wrote the optimum back into the GP.
        np.testing.assert_array_equal(gp.get_parameter_vector(), res.x)
        np.testing.assert_allclose(-gp.log_likelihood(y), res.fun,
                                   rtol=1e-10)
    # The first-steps tutorial's optimum (docs/tutorials/first.rst).
    gp = george_tpu_torch.GP(np.var(y) * tk.ExpSquaredKernel(0.5),
                             device="cpu")
    with pytest.raises(RuntimeError):
        optimize.minimize(gp, y, device="cpu")
    res = optimize.minimize(gp, y, x=x, yerr=yerr, method="dense",
                            device="cpu")
    np.testing.assert_allclose(res.fun, 9.225282556043894, rtol=1e-8)


def test_state_space_method_agrees():
    # The JAX package's test of the same name: the O(N) route (the Kalman
    # value+gradient's plain version here) and the dense route reach the
    # same optimum.
    x, y, yerr = _first_steps_data()
    gp = george_tpu_torch.GP(np.var(y) * tk.Matern32Kernel(2.0),
                             device="cpu")
    gp.compute(x, yerr)
    res_dense = optimize.minimize(gp, y, method="dense", set_params=False,
                                  device="cpu")
    res_ss = optimize.minimize(gp, y, method="state_space",
                               set_params=False, device="cpu")
    assert res_dense.success and res_ss.success
    np.testing.assert_allclose(res_ss.fun, res_dense.fun, rtol=1e-10)
    np.testing.assert_allclose(res_ss.x, res_dense.x, atol=1e-6)


def test_restarts_escape_local_minimum():
    # Quasi-periodic data: the period's likelihood is multimodal, and a
    # start at the wrong harmonic sticks in a local optimum that one
    # L-BFGS run does not leave; the batch of restarts finds the better
    # mode.
    rng = np.random.RandomState(42)
    x = np.sort(rng.uniform(0, 20, 80))
    yerr = 0.1 * np.ones_like(x)
    y = np.sin(2 * np.pi * x / 2.3) + yerr * rng.randn(len(x))
    gp = george_tpu_torch.GP(
        1.0 * tk.ExpSine2Kernel(gamma=2.0, log_period=np.log(7.0)),
        device="cpu")
    gp.compute(x, yerr)
    res0 = optimize.minimize(gp, y, set_params=False, device="cpu")
    res = optimize.minimize(gp, y, restarts=8, init_scale=1.5,
                            generator=torch.Generator().manual_seed(0),
                            set_params=False, device="cpu")
    assert res.fun <= res0.fun + 1e-9
    assert res.fun < res0.fun - 1.0      # a strictly better mode
    assert res.restart_funs.shape == (9,)
    np.testing.assert_allclose(res.restart_funs[0], res0.fun, rtol=1e-12)
    # The restarts come from the generator.
    theta0 = gp.get_parameter_vector()
    noise = 1.5 * torch.randn((8, len(theta0)), dtype=torch.float64,
                              generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(res.restart_x0[1:],
                                  theta0 + noise.numpy())


def test_bounds_and_prior():
    x, y, yerr = _first_steps_data()
    # The unconstrained optimum sits at log-metric 0.604 < log(2): with the
    # bound in place (the start in bounds at metric 4) the line search's
    # barrier keeps the iterates feasible.
    gp = george_tpu_torch.GP(np.var(y) * tk.ExpSquaredKernel(
        metric=4.0, metric_bounds=[(np.log(2.0), None)]), device="cpu")
    gp.compute(x, yerr)
    f0 = -gp.log_likelihood(y)
    res = optimize.minimize(gp, y, method="dense", tol=1e-6, device="cpu")
    assert res.x[-1] >= np.log(2.0) - 1e-9
    assert np.isfinite(res.fun) and res.fun < f0
    # A strong prior at 0 pulls the optimum toward 0 (MAP, not ML).
    gp = george_tpu_torch.GP(np.var(y) * tk.ExpSquaredKernel(0.5),
                             device="cpu")
    gp.compute(x, yerr)
    res_ml = optimize.minimize(gp, y, method="dense", set_params=False,
                               device="cpu")
    res_map = optimize.minimize(
        gp, y, method="dense", set_params=False, device="cpu",
        log_prior=lambda th: -0.5 * torch.sum((th / 0.5) ** 2))
    assert np.linalg.norm(res_map.x) < np.linalg.norm(res_ml.x)
