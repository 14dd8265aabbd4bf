# -*- coding: utf-8 -*-
"""The rest of the port's GP API against the JAX package's.

``GP(solver=StateSpaceSolver)`` (the likelihood, its gradient by the
Kalman value+gradient's plain version and, for a white-noise model that
varies with x, by autograd through the associative-scan filter; the
prediction, the solve and the draws), the trivial solver and the
empty-kernel GP, pickling, the kernels' gradient tensors and the native
point orderings, each held to ``george_tpu`` on the same inputs in float64
(the port on the CPU, JAX on the CPU in x64, as tests/conftest.py sets
it).  The draws compare through the same normals: the port's from a seeded
``torch.Generator``, mapped by the JAX package's square root.

At most four test functions: pytest-xdist's ``--dist loadfile`` hands out
the files with more tests first, and this one is to come after the suite's
long files.
"""

import pickle

import numpy as np
import pytest
import torch

import george_tpu
from george_tpu import kernels as jk
from george_tpu import modeling as jm
from george_tpu import utils as ju
from george_tpu.solvers import StateSpaceSolver as JaxStateSpace
from george_tpu.solvers import TrivialSolver as JaxTrivial

import george_tpu_torch
from george_tpu_torch import kernels as tk
from george_tpu_torch import modeling as tm
from george_tpu_torch import utils as tu
from george_tpu_torch.solvers import (BasicSolver, StateSpaceSolver,
                                      TrivialSolver)

# One intra-op thread: the tensors here are small, and the suite's workers
# run side by side.
torch.set_num_threads(1)

RTOL = 1e-9


def _close(got, ref, what, rtol=RTOL):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def _linear_noise(modeling):
    """A log white noise a + b x: a model that varies with x."""

    class LinearNoise(modeling.Model):
        parameter_names = ("a", "b")

        def get_value(self, x):
            return self.a + self.b * np.asarray(x)

        def compute_gradient(self, x):
            x = np.asarray(x)
            return np.vstack([np.ones_like(x), x])

    return LinearNoise


def _data(n=40, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, n)            # unsorted on purpose
    yerr = 0.05 + 0.1 * rng.random(n)
    y = np.sin(x) + 0.3 * np.cos(3.1 * x) + yerr * rng.standard_normal(n)
    return x, y, yerr


def _example07(k):
    return 1.0 * k.Matern32Kernel(2.0) + 0.3 * k.ExpKernel(0.5)


def test_state_space_gp_matches_jax():
    x, y, yerr = _data()
    # Five test points and five columns: one JAX compile of the solve.
    t = np.linspace(-1.0, 11.0, 5)
    for noise in ("constant", "varying"):
        def gp(pkg, k, modeling, **kw):
            wn = np.log(0.02) if noise == "constant" \
                else _linear_noise(modeling)(a=np.log(0.02), b=0.05)
            return pkg.GP(_example07(k), mean=0.2, fit_mean=True,
                          white_noise=wn, fit_white_noise=True, **kw)

        jgp = gp(george_tpu, jk, jm, solver=JaxStateSpace)
        tgp = gp(george_tpu_torch, tk, tm, solver=StateSpaceSolver,
                 device="cpu")
        assert isinstance(tgp.solver_type(tgp.kernel, device="cpu"),
                          StateSpaceSolver)
        jgp.compute(x, yerr)
        tgp.compute(x, yerr)
        _close(tgp.log_likelihood(y), jgp.log_likelihood(y), noise + " ll")
        g_ref = jgp.grad_log_likelihood(y)
        _close(tgp.grad_log_likelihood(y), g_ref, noise + " grad")
        mu_t, var_t = tgp.predict(y, t, return_var=True)
        mu_j, var_j = jgp.predict(y, t, return_var=True)
        _close(mu_t, mu_j, noise + " predictive mean")
        _close(var_t, var_j, noise + " predictive variance")
        _close(tgp.predict(y, t, return_cov=True)[1],
               jgp.predict(y, t, return_cov=True)[1], noise + " cov")
        Y = np.c_[y, np.cos(x), np.sin(2 * x), x, np.ones_like(x)]
        _close(tgp.apply_inverse(Y), jgp.apply_inverse(Y),
               noise + " apply_inverse")
        draws = tgp.sample(size=2, generator=torch.Generator().manual_seed(7))
        z = tu.standard_normal((2, len(x)), torch.Generator().manual_seed(7))
        _close(draws, jgp.solver.apply_sqrt(z) + jgp._call_mean(jgp._x),
               noise + " draws")
        # A frozen parameter drops out of the kernel route's gradient (the
        # JAX package's grad core compiles anew each call: it is not
        # asked again).
        name = "kernel:k1:k2:metric:log_M_0_0"
        frozen = tgp.get_parameter_names().index(name)
        tgp.freeze_parameter(name)
        _close(tgp.grad_log_likelihood(y), np.delete(g_ref, frozen),
               noise + " grad, one frozen")
    with pytest.raises(NotImplementedError):
        tgp.predictor(y)


def test_trivial_solver_and_empty_kernel():
    x, y, yerr = _data(seed=4)
    ts, js = TrivialSolver(), JaxTrivial()
    for s in (ts, js):
        s.compute(x, yerr)
    _close(ts.log_determinant, js.log_determinant, "log_determinant")
    _close(ts.dot_solve(y), js.dot_solve(y), "dot_solve")
    Y = np.c_[y, 2 * y]
    _close(ts.apply_inverse(Y), js.apply_inverse(Y), "apply_inverse")
    _close(ts.apply_inverse(torch.as_tensor(Y)).numpy(), js.apply_inverse(Y),
           "apply_inverse of a tensor")
    Yc = Y.copy()
    assert ts.apply_inverse(Yc, in_place=True) is Yc
    _close(ts.apply_sqrt(Y.T), js.apply_sqrt(Y.T), "apply_sqrt")
    _close(ts.get_inverse(), js.get_inverse(), "get_inverse")
    with pytest.raises(ValueError):
        TrivialSolver(tk.ExpKernel(1.0))

    tgp = george_tpu_torch.GP(mean=0.4, fit_mean=True, device="cpu")
    jgp = george_tpu.GP(mean=0.4, fit_mean=True)
    assert isinstance(george_tpu_torch.GP(tk.ExpKernel(1.0), device="cpu")
                      .solver_type(tk.ExpKernel(1.0), device="cpu"),
                      BasicSolver)
    for g in (tgp, jgp):
        g.compute(x, yerr)
    assert isinstance(tgp.solver, TrivialSolver)
    _close(tgp.log_likelihood(y), jgp.log_likelihood(y), "empty ll")
    _close(tgp.grad_log_likelihood(y), jgp.grad_log_likelihood(y),
           "empty grad")
    t = np.linspace(0, 10, 5)
    for a, b in zip(tgp.predict(y, t, return_var=True),
                    jgp.predict(y, t, return_var=True)):
        _close(a, b, "empty predict")
    draws = tgp.sample(size=3, generator=torch.Generator().manual_seed(3))
    z = tu.standard_normal((3, len(x)), torch.Generator().manual_seed(3))
    _close(draws, jgp.solver.apply_sqrt(z) + jgp._call_mean(jgp._x),
           "empty draws")

    # The package's top level names what the JAX package's does: the four
    # solvers, and ``optimize`` loaded on first use.
    assert george_tpu_torch.__all__ == george_tpu.__all__
    for name in george_tpu.__all__:
        assert getattr(george_tpu_torch, name) is not None, name
    assert george_tpu_torch.TrivialSolver is TrivialSolver
    assert george_tpu_torch.StateSpaceSolver is StateSpaceSolver
    assert george_tpu_torch.HODLRSolver.__module__ == \
        "george_tpu_torch.solvers.hodlr"
    assert george_tpu_torch.optimize.__name__ == "george_tpu_torch.optimize"


def _fail_compute(*args, **kwargs):
    raise AssertionError("unpickled GP shouldn't need to be computed")


def test_pickle_round_trip():
    # The JAX package's tests/test_pickle.py, both of the port's solvers: a
    # BasicSolver GP answers without recompute; a StateSpaceSolver GP
    # recomputes and gives the same answers.
    rng = np.random.default_rng(123)
    x = rng.random(100)
    y = np.sin(x)
    for solver, kernel, survives in (
            (BasicSolver, lambda k: 0.1 * k.ExpSquaredKernel(1.5), True),
            (StateSpaceSolver, _example07, False)):
        gp = george_tpu_torch.GP(kernel(tk), solver=solver, device="cpu")
        gp.compute(x, 1e-2)
        ll0 = gp.log_likelihood(y)
        grad0 = gp.grad_log_likelihood(y)
        jgp = george_tpu.GP(kernel(jk), solver=getattr(
            george_tpu.solvers, solver.__name__))
        jgp.compute(x, 1e-2)
        _close(ll0, jgp.log_likelihood(y), solver.__name__ + " ll")
        gp = pickle.loads(pickle.dumps(gp, -1))
        assert gp.device == torch.device("cpu")
        assert gp.dtype == torch.float64
        if survives:
            gp.compute = _fail_compute
            assert gp.computed
        assert gp.log_likelihood(y) == ll0
        np.testing.assert_array_equal(gp.grad_log_likelihood(y), grad0)

    k = 0.4 * tk.Matern32Kernel([1.0, 2.0], ndim=2) \
        + tk.ExpSine2Kernel(gamma=1.0, log_period=0.5, ndim=2)
    k2 = pickle.loads(pickle.dumps(k, -1))
    np.testing.assert_array_equal(k.get_parameter_vector(),
                                  k2.get_parameter_vector())
    xs = rng.random((7, 2))
    np.testing.assert_array_equal(k.get_value(xs, device="cpu"),
                                  k2.get_value(xs, device="cpu"))


def _gradient_trees(k):
    """A stationary kernel under a general metric, a product of two
    stationary kernels, and a sum with a non-stationary leaf."""
    return [
        1.3 * k.RationalQuadraticKernel(
            log_alpha=0.3, metric=[[1.5, 0.2], [0.2, 0.8]], ndim=2),
        k.ExpSquaredKernel(metric=[0.7, 1.4], ndim=2)
        * k.Matern52Kernel(metric=2.0, ndim=2),
        k.PolynomialKernel(log_sigma2=0.1, order=2, ndim=2)
        + k.CosineKernel(log_period=0.4, ndim=2, axes=1),
    ]


def test_kernel_gradients_and_orderings():
    rng = np.random.default_rng(5)
    x1 = rng.standard_normal((6, 2))
    x2 = rng.standard_normal((5, 2))
    for i, (a, b) in enumerate(zip(_gradient_trees(jk),
                                   _gradient_trees(tk))):
        for k in (a, b):
            k.freeze_parameter(k.get_parameter_names()[0])
        for m in ("get_x1_gradient", "get_x2_gradient"):
            _close(getattr(b, m)(x1, x2, device="cpu"), getattr(a, m)(x1, x2),
                   "{0} tree {1}".format(m, i), rtol=1e-10)
            # x2 None is x2 = x1 (each shape is a JAX compile: the port's
            # own cross form is the reference here).
            np.testing.assert_array_equal(getattr(b, m)(x1, device="cpu"),
                                          getattr(b, m)(x1, x1, device="cpu"))
        for frozen in (False, True):
            _close(b.get_gradient(x1, x2, include_frozen=frozen,
                                  device="cpu"),
                   a.get_gradient(x1, x2, include_frozen=frozen),
                   "get_gradient tree {0}".format(i), rtol=1e-10)
        np.testing.assert_array_equal(b.get_gradient(x1, device="cpu"),
                                      b.get_gradient(x1, x1, device="cpu"))
        b.test_gradient(x1, x2, device="cpu")
        b.test_x1_gradient(x1.copy(), x2, device="cpu")
        b.test_x2_gradient(x1, x2.copy(), device="cpu")

    # The orderings run in the port's own C++ library: the same
    # permutations as the JAX package's.
    for shape, seed in (((257, 3), 7), ((100, 2), 3), ((64, 1), 1),
                        ((1, 2), 2)):
        pts = np.random.default_rng(seed).standard_normal(shape)
        for name in ("nd_sort_samples", "kd_sort_samples",
                     "hilbert_sort_samples"):
            np.testing.assert_array_equal(getattr(tu, name)(pts),
                                          getattr(ju, name)(pts),
                                          err_msg=name)
        np.testing.assert_array_equal(tu.hilbert_sort_samples(pts, bits=8),
                                      ju.hilbert_sort_samples(pts, bits=8))
