# -*- coding: utf-8 -*-
"""The port's HODLR solver and sampler engine against the JAX package's.

``ops/hodlr_core``: the factorization of a 1-D sum kernel (ExpSquared +
Matern32) at N = 700 and of a 3-D ExpSquared at N = 300 in KD order, with
``min_size`` 64, at ``tol`` 1e-10 and 0.1: the log-determinant, the
adaptive ACA's recorded pivots (rows, columns and counts a level),
``hodlr_solve`` and ``hodlr_dot_solve`` at rtol 1e-10 (float64 on both
sides: the port on the CPU, JAX on the CPU in x64, as tests/conftest.py
sets it).  The JAX side is its ``_compute_all_fn(pivot_mode="record")``
at the tol-1e-10 rank caps for both tolerances, so that one compile a
geometry serves both: below its caps a block stops at the same step
whatever the cap, and the columns beyond are zero.  Then the gradient
core with a white-noise direction, the ``GP(solver=HODLRSolver)`` API
and the sampler route (``build_gp_log_prob(method="hodlr")``, fixed
pivots, 4 chains; config 4's model at N = 160) at rtol 1e-9.

At most four test functions (``--dist loadfile`` queues the files with
fewer tests last); every JAX program is compiled once.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import george_tpu
from george_tpu import kernels as jk
from george_tpu import utils as ju
from george_tpu.ops import hodlr_core as jh
from george_tpu.samplers import build_gp_log_prob as jax_build

import george_tpu_torch
from george_tpu_torch import kernels as tk
from george_tpu_torch.ops import hodlr_core as th
from george_tpu_torch.samplers import build_gp_log_prob as torch_build
from george_tpu_torch.solvers import BasicSolver, HODLRSolver

torch.set_num_threads(1)

RTOL = 1e-10
MIN_SIZE = 64


def _close(got, ref, what, rtol=RTOL):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max(), err_msg=what)


def _geometries():
    rng = np.random.default_rng(0)
    x1 = np.sort(rng.uniform(0, 50, 700))[:, None]
    x3 = rng.uniform(0, 5, (300, 3))
    x3 = x3[np.asarray(ju.kd_sort_samples(x3))]
    return [
        ("1-D sum", x1,
         lambda k: 1.3 * k.ExpSquaredKernel(2.0) + 0.5 * k.Matern32Kernel(5.0)),
        ("3-D", x3, lambda k: 1.0 * k.ExpSquaredKernel(10.0, ndim=3)),
    ]


def _jax_record(jkern, x, diag, ranks, tol):
    """The JAX package's factorization and pivots at ``ranks``."""
    n = len(x)
    levels, n_pad, leaf = jh.plan_tree(n, MIN_SIZE)
    pad = n_pad - n
    x_pad = np.concatenate([x, np.broadcast_to(x[-1:], (pad, x.shape[1]))])
    rec = jh._compute_all_fn(jkern.spec_node(), levels, leaf, ranks,
                             pivot_mode="record")
    leaf_chol, U0s, V0s, Uts, Vts, S_lus, stats, pivots = rec(
        jnp.asarray(jkern.get_parameter_vector(include_frozen=True)),
        jnp.asarray(x_pad), jnp.asarray(np.concatenate([diag, np.ones(pad)])),
        jnp.arange(n_pad) < n, jnp.asarray(tol))
    fact = jh.HODLRFactorization(
        n=n, n_pad=n_pad, levels=levels, leaf_size=leaf, leaf_chol=leaf_chol,
        level_U0=list(U0s), level_V0=list(V0s), level_Ut=list(Uts),
        level_Vt=list(Vts), level_S_lu=list(S_lus),
        log_determinant=float(stats[0]))
    return fact, pivots


def _same_pivots(mine, ref, what):
    for q, (mp, rp) in enumerate(zip(mine, ref)):
        rows, cols, _, nk = (v[0].numpy() for v in mp)
        jrows, jcols, _, jnk = (np.asarray(v) for v in rp)
        np.testing.assert_array_equal(nk, jnk, err_msg=what)
        for i, k in enumerate(nk):
            np.testing.assert_array_equal(rows[i, :k], jrows[i, :k],
                                          err_msg=what)
            np.testing.assert_array_equal(cols[i, :k], jcols[i, :k],
                                          err_msg=what)
        assert nk.min() > 0, "level {0} compressed nothing".format(q)


def test_hodlr_core_matches_jax():
    rng = np.random.default_rng(1)
    for name, x, make in _geometries():
        n = len(x)
        diag = 0.1 ** 2 + 0.02 * rng.random(n)
        jkern, tkern = make(jk), make(tk)
        y = rng.standard_normal(n)
        ranks = None
        for tol in (1e-10, 0.1):
            what = "{0}, tol {1}".format(name, tol)
            mine = th.hodlr_compute(
                tkern.spec_node(),
                tkern.get_parameter_vector(include_frozen=True), x, diag,
                min_size=MIN_SIZE, tol=tol, device="cpu")
            ranks = ranks or mine.ranks
            ref, pivots = _jax_record(jkern, x, diag, ranks, tol)
            _same_pivots(mine.pivots, pivots, what)
            _close(mine.log_determinant, ref.log_determinant,
                   what + ": log det")
            _close(th.hodlr_solve(mine, y), jh.hodlr_solve(ref, y),
                   what + ": solve")
            _close(th.hodlr_dot_solve(mine, y), jh.hodlr_dot_solve(ref, y),
                   what + ": dot solve")
            if tol == 1e-10:
                # At a tight tolerance the likelihood is the dense one, to
                # the compression's error.
                dense = BasicSolver(tkern, device="cpu")
                dense.compute(x, np.sqrt(diag))
                _close(-0.5 * (mine.log_determinant
                               + float(th.hodlr_dot_solve(mine, y))),
                       -0.5 * (dense.log_determinant + dense.dot_solve(y)),
                       what + ": log-likelihood against BasicSolver",
                       rtol=1e-9)


def test_grad_core_matches_jax():
    rng = np.random.default_rng(2)
    name, x, make = _geometries()[1]
    n = len(x)
    jkern, tkern = make(jk), make(tk)
    yerr2 = 0.05 ** 2 * np.ones(n)
    wn = np.log(0.08 ** 2) + 0.1 * np.sin(x[:, 0])
    dirs = x[None, :, 1]
    r = rng.standard_normal(n)
    mine = th.hodlr_compute(
        tkern.spec_node(), tkern.get_parameter_vector(include_frozen=True), x,
        yerr2 + np.exp(wn), min_size=MIN_SIZE, tol=1e-10, device="cpu")
    ref, _ = _jax_record(jkern, x, yerr2 + np.exp(wn), mine.ranks, 1e-10)
    theta = jkern.get_parameter_vector(include_frozen=True)
    g_ref = jh.hodlr_grad_core(jkern.spec_node(), ref, theta, wn, x, r, yerr2,
                               1e-10, wn_dirs=dirs, theta_idx=(1,))
    g_mine = th.hodlr_grad_core(tkern.spec_node(), mine, theta, wn, x, r,
                                yerr2, 1e-10, wn_dirs=dirs, theta_idx=(1,))
    for a, b, what in zip(g_mine, g_ref, ("kernel", "white noise", "alpha")):
        _close(a, b, "grad core: " + what, rtol=1e-9)


def test_gp_api_with_hodlr_solver():
    name, x, make = _geometries()[0]
    rng = np.random.default_rng(3)
    yerr = 0.1 + 0.05 * rng.random(len(x))
    y = np.sin(x[:, 0] / 3.0) + yerr * rng.standard_normal(len(x))
    gps = [george_tpu_torch.GP(make(tk), white_noise=np.log(0.01),
                               fit_white_noise=True, device="cpu", **kw)
           for kw in (dict(solver=HODLRSolver, tol=1e-10, min_size=MIN_SIZE),
                      {})]
    for gp in gps:
        gp.compute(x[:, 0], yerr)
    hodlr, dense = gps
    assert isinstance(hodlr.solver, HODLRSolver)
    _close(hodlr.log_likelihood(y), dense.log_likelihood(y),
           "log-likelihood", rtol=1e-9)
    _close(hodlr.grad_log_likelihood(y), dense.grad_log_likelihood(y),
           "gradient", rtol=1e-7)
    _close(hodlr.apply_inverse(y), dense.apply_inverse(y), "apply_inverse",
           rtol=1e-8)
    mu, var = hodlr.predict(y, x[:5, 0], return_var=True)
    mu_d, var_d = dense.predict(y, x[:5, 0], return_var=True)
    _close(mu, mu_d, "predictive mean", rtol=1e-8)
    with pytest.raises(NotImplementedError):
        hodlr.sample()
    # Pickling drops the factorization; the loaded GP recomputes it.
    loaded = pickle.loads(pickle.dumps(hodlr, -1))
    assert not loaded.solver.computed and loaded.solver._fact is None
    _close(loaded.log_likelihood(y), hodlr.log_likelihood(y),
           "log-likelihood after pickling", rtol=1e-12)


def test_sampler_route_matches_jax():
    # Config 4's model (benchmarks/hodlr_sampler.py) at N = 160, two levels.
    rng = np.random.default_rng(42)
    n = 160
    x = np.sort(rng.uniform(0, 16, n))
    yerr = 0.1 * np.ones(n)
    y = np.sin(x / 4.0) + yerr * rng.standard_normal(n)
    opts = dict(tol=1e-4, min_size=40)
    jgp = george_tpu.GP(1.0 * jk.ExpSquaredKernel(4.0),
                        white_noise=np.log(1e-3), fit_white_noise=True)
    tgp = george_tpu_torch.GP(1.0 * tk.ExpSquaredKernel(4.0),
                              white_noise=np.log(1e-3), fit_white_noise=True,
                              device="cpu")
    jlp, theta0 = jax_build(jgp, x, y, yerr, method="hodlr",
                            method_options=dict(opts))
    tlp, _ = torch_build(tgp, x, y, yerr, method="hodlr",
                         method_options=dict(opts), device="cpu")
    assert tlp.engine == "hodlr"
    assert tlp.hodlr_ranks[0] < 80     # the replay is compressed
    thetas = np.asarray(theta0) + 0.2 * rng.standard_normal((4, 3))
    ref_lp, ref_g = jlp.batched_value_and_grad(jnp.asarray(thetas))
    mine_lp, mine_g = tlp.batched_value_and_grad(torch.as_tensor(thetas))
    # The JAX batched value is its log_prob's (the same density).
    _close(tlp(torch.as_tensor(thetas)), ref_lp, "log_prob", rtol=1e-9)
    _close(mine_lp, ref_lp, "batched value", rtol=1e-9)
    _close(mine_g, ref_g, "batched gradient", rtol=1e-9)
    with pytest.raises(TypeError):
        torch_build(tgp, x, y, yerr, method="hodlr",
                    method_options={"bogus": 1}, device="cpu")
