# -*- coding: utf-8 -*-
"""The port's O(N) state-space solver against the JAX package's.

The solver's functions (``george_tpu_torch/ops/state_space.py``: the
system, the filter, the smoother, the innovations square root and the
likelihoods) and ``solvers.StateSpaceSolver`` are held to
``george_tpu/ops/state_space.py`` and ``george_tpu/solvers/state_space.py``
in float64 (the port on the CPU, JAX on the CPU in x64, as
tests/conftest.py sets it), and the port's scan forms (the data-free
covariances by the associative-scan filter, the columns by affine scans)
to its sequential plain models.  The JAX side runs on
examples/07_state_space.py's kernel, jitted, the solver's functions at the
shapes the solver has compiled them for; the scan forms run over three
trees.

At most four test functions: pytest-xdist's ``--dist loadfile`` hands out
the files with more tests first, and this one is to come after the suite's
long files.
"""

import numpy as np
import pytest
import torch

import jax

from george_tpu import kernels as jk
from george_tpu.ops import state_space as jss
from george_tpu.solvers import StateSpaceSolver as JaxSolver

from george_tpu_torch import kernels as tk
from george_tpu_torch.ops import state_space as tss
from george_tpu_torch.solvers import StateSpaceSolver

# One intra-op thread: the tensors here are small, and the suite's workers
# run side by side.
torch.set_num_threads(1)

RTOL = 1e-10


def _kernels(k):
    """examples/07_state_space.py's kernel, and the other families."""
    return {
        "example07": lambda: 1.0 * k.Matern32Kernel(2.0)
        + 0.3 * k.ExpKernel(0.5),
        "matern52": lambda: 2.0 * k.Matern52Kernel(1.3),
        "cosine_const": lambda: 0.3 * k.CosineKernel(log_period=0.7)
        + k.ConstantKernel(log_constant=-0.5) + 1.1 * k.Matern32Kernel(2.0),
    }


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, n)            # unsorted on purpose
    yerr = 0.05 + 0.1 * rng.random(n)
    y = np.sin(x) + yerr * rng.standard_normal(n)
    return x, y, yerr, rng


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _close(got, ref, what, rtol=RTOL):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max(), err_msg=what)


N = 37


def test_solver_matches_jax():
    x, y, yerr, rng = _data(N, seed=3)
    for name in ("example07",):
        ts = StateSpaceSolver(_kernels(tk)[name](), device="cpu")
        js = JaxSolver(_kernels(jk)[name]())
        ts.compute(x, yerr)
        js.compute(x, yerr)
        _close(ts.log_determinant, js.log_determinant, name + " logdet")
        _close(ts.dot_solve(y), js.dot_solve(y), name + " dot_solve")
        Y = np.c_[y, rng.standard_normal((len(x), 2))]
        _close(ts.apply_inverse(y), js.apply_inverse(y), name + " 1 column")
        _close(ts.apply_inverse(Y), js.apply_inverse(Y), name + " 3 columns")
        Z = rng.standard_normal((2, len(x)))
        _close(ts.apply_sqrt(Z), js.apply_sqrt(Z), name + " apply_sqrt")
        _close(ts.apply_sqrt(Z[0]), js.apply_sqrt(Z[0]), name + " one row")
        _close(ts.get_inverse(), js.get_inverse(), name + " get_inverse")
        # in_place overwrites a numpy input of the result's shape.
        Yc = Y.copy()
        assert ts.apply_inverse(Yc, in_place=True) is Yc
        _close(Yc, js.apply_inverse(Y), name + " in place")
        # A tensor gives a tensor on the solver's device.
        out = ts.apply_inverse(_t(Y))
        assert torch.is_tensor(out)
        _close(out.numpy(), js.apply_inverse(Y), name + " tensor")


def test_solver_raises_where_jax_raises():
    x, y, yerr, rng = _data(N, seed=3)
    # A non-Markovian leaf, 2-D inputs, a product of Markovian leaves.
    for unsupported in (lambda k: k.ExpSquaredKernel(1.0),
                        lambda k: k.Matern32Kernel(1.0, ndim=2),
                        lambda k: k.Matern32Kernel(1.0) * k.ExpKernel(2.0)):
        with pytest.raises(ValueError):
            StateSpaceSolver(unsupported(tk), device="cpu")
        with pytest.raises(ValueError):
            JaxSolver(unsupported(jk))
    solver = StateSpaceSolver(_kernels(tk)["example07"](), device="cpu")
    jsolver = JaxSolver(_kernels(jk)["example07"]())
    for s in (solver, jsolver):
        with pytest.raises(ValueError):
            s.compute(np.c_[x, x], yerr)
        with pytest.raises(ValueError):
            s.compute(x, 0.0)
        with pytest.raises(ValueError):
            s.compute(x, np.r_[yerr[:-1], 0.0])


def _jax_fns(node):
    build = jss.system_fn(node)

    @jax.jit
    def filt(th, t, y, v):
        sys = build(th, t)
        return sys, jss.kalman_filter(*sys, y, v), \
            jss.rts_smoother_means(*sys, y, v)

    return dict(
        filter=filt,
        grad_core=jss.state_space_grad_core_fn(node),
        parallel=jax.jit(jss.state_space_loglike_fn(node, "parallel")),
    )


def test_functions_match_jax():
    # The solver test's data: the JAX solver's jitted functions
    # (george_tpu/solvers/state_space.py) are compiled for these shapes.
    from george_tpu.solvers import state_space as jsolver

    x, y, yerr, rng = _data(N, seed=3)
    order = np.argsort(x, kind="stable")
    t, y, v = x[order], y[order], yerr[order] ** 2
    kernel = _kernels(tk)["example07"]()
    node = kernel.spec_node()
    jnode = _kernels(jk)["example07"]().spec_node()
    jf = _jax_fns(jnode)
    th = kernel.get_parameter_vector(include_frozen=True)
    tt, tv, ty = _t(t), _t(v), _t(y)
    sys_t = tss.system_fn(node)(_t(th), tt)
    sys_j, out_j, smooth_j = jf["filter"](th, t, y, v)
    for a, b, what in zip(sys_t, sys_j, ("Phi", "Q", "Pinf", "h")):
        _close(a.numpy(), b, what)
    out_t = tss.kalman_filter(*sys_t, ty, tv)
    for a, b, what in zip(out_t, out_j,
                          ("S", "innov", "m_f", "P_f", "m_p", "P_p")):
        _close(a.numpy(), b, "filter " + what)
    _close(tss.rts_smoother_means(*sys_t, ty, tv).numpy(), smooth_j,
           "smoother")
    logdet, _ = tss.state_space_factor_fn(node)(_t(th), tt, tv)
    _close(float(logdet), float(jsolver._factor_cached(jnode)(th, t, v)[0]),
           "factor")
    Y = np.c_[y, rng.standard_normal((len(t), 2))]
    _close(tss.state_space_apply_inverse_fn(node)(_t(th), tt, tv,
                                                  _t(Y)).numpy(),
           jsolver._apply_inverse_cached(jnode)(th, t, v, Y),
           "apply_inverse")
    Z = rng.standard_normal((2, len(t)))
    _close(tss.state_space_apply_sqrt_fn(node)(_t(th), tt, tv,
                                               _t(Z)).numpy(),
           jsolver._apply_sqrt_cached(jnode)(th, t, v, Z), "apply_sqrt")
    wn = np.log(0.01) + 0.3 * rng.standard_normal(len(t))
    got = tss.state_space_grad_core_fn(node)(_t(th), _t(wn), tt, ty, tv)
    ref = jf["grad_core"](th, wn, t, y, v)
    for a, b, what in zip(got, ref, ("g_theta", "g_wn", "alpha")):
        _close(a.numpy(), b, "grad_core " + what, rtol=1e-9)
    ll_par = float(jf["parallel"](th, t, y, v))
    for method in ("parallel", "sequential"):
        _close(float(tss.state_space_loglike_fn(node, method)(
            _t(th), tt, ty, tv)), ll_par, "loglike " + method)
    with pytest.raises(ValueError):
        tss.state_space_loglike_fn(node, "scan")
    # An empty tree gives the diagonal likelihood.
    empty = tk.EmptyKernel().spec_node()
    ll = tss.state_space_loglike_fn(empty)(_t([]), tt, ty, tv)
    _close(float(ll), float(np.sum(-0.5 * (np.log(2 * np.pi * v)
                                          + y * y / v))), "empty")


def test_scan_forms_match_sequential_models():
    for n in (1, 2, 5, 40):
        x, y, yerr, rng = _data(n, seed=n)
        t, v = _t(np.sort(x)), _t(yerr ** 2)
        for name in _kernels(tk):
            kernel = _kernels(tk)[name]()
            Phi, Q, Pinf, h = tss.system_fn(kernel.spec_node())(
                _t(kernel.get_parameter_vector(include_frozen=True)), t)
            Y = _t(rng.standard_normal((n, 3)))
            S, innov, m_f, P_f, m_p, P_p = tss.kalman_filter(Phi, Q, Pinf, h,
                                                             Y, v)
            S2, K2, P_f2, P_p2 = tss.filter_covariances(Phi, Q, Pinf, h, v)
            what = "{0} N={1}".format(name, n)
            for a, b, w in ((S2, S, "S"), (P_f2, P_f, "P_f"),
                            (P_p2, P_p, "P_p")):
                _close(a.numpy(), b.numpy(), what + " " + w)
            m_f2, m_p2, innov2 = tss.filter_means(Phi, h, K2, Y)
            for a, b, w in ((m_f2, m_f, "m_f"), (m_p2, m_p, "m_p"),
                            (innov2, innov, "innov")):
                _close(a.numpy(), b.numpy(), what + " " + w)
            G = tss.smoother_gains(Phi, P_f2, P_p2)
            _close(tss.smoother_means(G, m_f2, m_p2).numpy(),
                   tss.rts_smoother_means(Phi, Q, Pinf, h, Y, v).numpy(),
                   what + " smoother")
            Z = _t(rng.standard_normal((n, 2)))
            _close(tss.sample_scan(Phi, h, S2, K2, Z).numpy(),
                   tss.sample_sequential(Phi, Q, Pinf, h, Z.T, v).T.numpy(),
                   what + " draws")
            # The factor in column chunks of 1 gives the same columns.
            terms = tss.extract_terms(kernel.spec_node())
            th = _t(kernel.get_parameter_vector(include_frozen=True))
            whole = tss.StateSpaceFactor(terms, th, torch.diff(t), v)
            ones = tss.StateSpaceFactor(terms, th, torch.diff(t), v, chunk=1)
            _close(ones.apply_inverse(Y).numpy(),
                   whole.apply_inverse(Y).numpy(), what + " chunks")
