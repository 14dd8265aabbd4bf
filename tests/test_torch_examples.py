# -*- coding: utf-8 -*-
"""The custom-model hook and the port's examples against the JAX package.

``torch_value(params, x)`` is the port's counterpart of the JAX package's
``jax_value`` hook: a mean or white-noise model that defines it takes part
in every density ``build_gp_log_prob`` builds.  Its value and gradient are
held to the JAX package's ``jax_value`` density at rtol 1e-10 (float64 on
both sides: the port on the CPU, JAX on the CPU in x64, as
tests/conftest.py sets it) on the dense, state-space (sequential and
associative-scan) and HODLR routes and through ``optimize.minimize``.
``examples_torch/`` 01, 03, 04, 05 and 07 (the GP API) are held to the same
models and data through the JAX package at rtol 1e-9 (07's likelihood
gradient at 1e-7, as the port's GP tests hold it); 02, 06, 08 and 09
(the samplers) run at a few chains and steps with finite summaries and
their engines named (no JAX sampler is an oracle here).

At most four test functions (``--dist loadfile`` queues the files with
fewer tests last); every JAX oracle is jitted.
"""

import glob
import importlib.util
import logging
import os

import numpy as np
import pytest
import torch
import yaml
from scipy.optimize import minimize as sp_minimize

import jax
import jax.numpy as jnp

import george_tpu
from george_tpu import kernels as jk
from george_tpu.modeling import Model as JModel
from george_tpu.samplers import build_gp_log_prob as jax_build

import george_tpu_torch
from george_tpu_torch import kernels as tk
from george_tpu_torch import optimize
from george_tpu_torch.modeling import Model as TModel
from george_tpu_torch.samplers import build_gp_log_prob as torch_build
from george_tpu_torch.samplers import traceable_model_fn
from george_tpu_torch.solvers import BasicSolver

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples_torch")


def _example(number):
    """Import ``examples_torch/<number>_*.py`` as a module."""
    path, = glob.glob(os.path.join(EXAMPLES, "{0}_*.py".format(number)))
    spec = importlib.util.spec_from_file_location(
        "examples_torch_{0}".format(number), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _close(got, ref, what, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(ref, dtype=np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


class JLinearMean(JModel):
    parameter_names = ("m", "b")

    def get_value(self, x):
        return self.m * x + self.b

    @JModel.parameter_sort
    def compute_gradient(self, x):
        return dict(m=x, b=np.ones(len(x)))

    def jax_value(self, params, x):
        return params[0] * x[:, 0] + params[1]


class TLinearMean(TModel):
    parameter_names = ("m", "b")

    def get_value(self, x):
        return self.m * x + self.b

    @TModel.parameter_sort
    def compute_gradient(self, x):
        return dict(m=x, b=np.ones(len(x)))

    def torch_value(self, params, x):
        return params[0] * x[:, 0] + params[1]


class JLogNoise(JModel):
    """A log white-noise variance linear in x."""

    parameter_names = ("c0", "c1")

    def get_value(self, x):
        # (N,) or, from the JAX package's HODLR route, (N, 1) inputs.
        return self.c0 + self.c1 * np.ravel(x)

    def jax_value(self, params, x):
        return params[0] + params[1] * x[:, 0]


class TLogNoise(TModel):
    parameter_names = ("c0", "c1")

    def get_value(self, x):
        return self.c0 + self.c1 * np.ravel(x)

    def torch_value(self, params, x):
        return params[0] + params[1] * x[:, 0]


def _linear_data(n=32):
    # tests/test_samplers.py's test_custom_jax_value_mean_model data.
    np.random.seed(0)
    x = np.sort(np.random.uniform(0, 5, n))
    yerr = 0.1 * np.ones(n)
    y = 0.5 * x + 1.0 + yerr * np.random.randn(n)
    return x, y, yerr


def _jax_vg(lp, thetas):
    """The JAX density's batched value and gradient: its attached engine
    where it has one (HODLR's forward-mode sweeps), else jit of
    vmap(value_and_grad)."""
    vg = getattr(lp, "batched_value_and_grad", None) \
        or jax.jit(jax.vmap(jax.value_and_grad(lp)))
    v, g = vg(jnp.asarray(thetas))
    return np.asarray(v), np.asarray(g)


def _torch_vg(lp, thetas):
    th = torch.as_tensor(thetas).requires_grad_(True)
    v = lp(th)
    g, = torch.autograd.grad(v.sum(), th)
    return v.detach().numpy(), g.numpy()


def _points(theta0, count, seed, scale=0.1):
    theta0 = np.asarray(theta0, dtype=np.float64)
    rng = np.random.default_rng(seed)
    return np.vstack([theta0[None], theta0 + scale * rng.standard_normal(
        (count, len(theta0)))])


def _pair(kernel, **kw):
    """The same GP in both packages: ``kernel(module)`` builds the kernel,
    ``kw`` maps to (JAX value, port value)."""
    jkw = {k: v[0] for k, v in kw.items()}
    tkw = {k: v[1] for k, v in kw.items()}
    jgp = george_tpu.GP(None if kernel is None else kernel(jk), **jkw)
    tgp = george_tpu_torch.GP(None if kernel is None else kernel(tk),
                              device="cpu", **tkw)
    return jgp, tgp


def test_torch_value_mean_model(caplog):
    # The port of tests/test_samplers.py's test_custom_jax_value_mean_model.
    x, y, yerr = _linear_data()
    jgp, tgp = _pair(lambda k: 1.0 * k.ExpSquaredKernel(1.0),
                     mean=(JLinearMean(0.5, 1.0), TLinearMean(0.5, 1.0)),
                     fit_mean=(True, True))
    tgp.compute(x, yerr)
    jlp, jtheta0 = jax_build(jgp, x, y, yerr)
    tlp, ttheta0 = torch_build(tgp, x, y, yerr, device="cpu")
    # A two-parameter mean leaves the dense route on its plain autograd
    # density, as in the JAX package.
    assert tlp.engine == "torch_dense_autograd"
    assert not hasattr(tlp, "batched_value_and_grad")
    thetas = _points(jtheta0, 4, 1)
    _close(ttheta0.numpy(), jtheta0, "theta0", rtol=0, atol=0)
    v, g = _torch_vg(tlp, thetas)
    v_ref, g_ref = _jax_vg(jlp, thetas)
    _close(v, v_ref, "value")
    _close(g, g_ref, "gradient")
    _close(float(tlp(ttheta0)), tgp.log_likelihood(y), "value at theta0 "
           "against GP.log_likelihood", rtol=1e-10)
    _close(g[0], tgp.grad_log_likelihood(y), "gradient at theta0 against "
           "GP.grad_log_likelihood", rtol=1e-7, atol=1e-9)

    # On the state-space route the fused Kalman value+gradient is not
    # attached (tests/test_pallas_kalman.py's
    # test_not_attached_for_unsupported_models), and a note says why.
    jgp, tgp = _pair(lambda k: 1.0 * k.Matern32Kernel(1.0),
                     mean=(JLinearMean(0.1, 0.0), TLinearMean(0.1, 0.0)),
                     fit_mean=(True, True))
    jlp, jtheta0 = jax_build(jgp, x, y, yerr)
    with caplog.at_level(logging.WARNING, logger="george_tpu_torch"):
        tlp, _ = torch_build(tgp, x, y, yerr, device="cpu")
    assert tlp.engine == "torch_state_space"
    assert not hasattr(tlp, "batched_value_and_grad")
    assert any("state-space sampler path" in r.getMessage() and
               "mean model" in r.getMessage() for r in caplog.records)
    thetas = _points(jtheta0, 4, 2)
    v, g = _torch_vg(tlp, thetas)
    v_ref, g_ref = _jax_vg(jlp, thetas)
    _close(v, v_ref, "state-space value")
    _close(g, g_ref, "state-space gradient")

    # A model with active parameters and neither form names the hook.
    class Opaque(TModel):
        parameter_names = ("a",)

        def get_value(self, x):
            return self.a * np.ones(len(x))

    tgp = george_tpu_torch.GP(1.0 * tk.ExpSquaredKernel(1.0), mean=Opaque(0.1),
                              fit_mean=True, device="cpu")
    with pytest.raises(TypeError, match="torch_value"):
        torch_build(tgp, x, y, yerr, device="cpu")


def test_custom_model_routes():
    x, y, yerr = _linear_data(48)
    models = dict(mean=(JLinearMean(0.4, 0.8), TLinearMean(0.4, 0.8)),
                  fit_mean=(True, True),
                  white_noise=(JLogNoise(-6.0, 0.1), TLogNoise(-6.0, 0.1)),
                  fit_white_noise=(True, True))
    cases = (
        (lambda k: 1.0 * k.Matern32Kernel(1.0), "dense", None),
        (lambda k: 1.0 * k.Matern32Kernel(1.0), "state_space_parallel", None),
        (lambda k: 1.0 * k.ExpSquaredKernel(1.0), "hodlr",
         dict(tol=1e-10, min_size=12)),
    )
    for kernel, method, opts in cases:
        jgp, tgp = _pair(kernel, **models)
        kw = {} if opts is None else dict(method_options=opts)
        jlp, jtheta0 = jax_build(jgp, x, y, yerr, method=method,
                                 **({} if opts is None else
                                    dict(method_options=dict(opts))))
        tlp, _ = torch_build(tgp, x, y, yerr, method=method, device="cpu",
                             **kw)
        thetas = _points(jtheta0, 3, 3)
        v, g = _torch_vg(tlp, thetas)
        v_ref, g_ref = _jax_vg(jlp, thetas)
        _close(v, v_ref, method + " value")
        _close(g, g_ref, method + " gradient", atol=1e-10)
        if method == "hodlr":
            # The HODLR engine's batched value+gradient, one backward pass.
            bv, bg = tlp.batched_value_and_grad(torch.as_tensor(thetas))
            _close(bv.numpy(), v_ref, "hodlr batched value")
            _close(bg.numpy(), g_ref, "hodlr batched gradient", atol=1e-10)

    # Shape-polymorphic without baked constants (the data-sharded
    # factories' allow_baked=False): a rank's rows, not x_host's.
    xs = np.linspace(0.0, 3.0, 7)[:, None]
    params = np.array([[0.4, 0.8], [-1.0, 2.0]])
    fn = traceable_model_fn(TLinearMean(0.4, 0.8), x[:, None], "cpu",
                            torch.float64, allow_baked=False)
    ref = jax.vmap(JLinearMean(0.4, 0.8).jax_value, in_axes=(0, None))(
        jnp.asarray(params), jnp.asarray(xs))
    _close(fn(torch.as_tensor(params), torch.as_tensor(xs)).numpy(), ref,
           "torch_value on other rows")

    # optimize.minimize over a custom mean and white noise: its optimum is
    # scipy's over the JAX GP's nll / grad_nll, and its objective the JAX
    # GP's at the same point.  (A correlated signal on the line, so that
    # the kernel's parameters have an optimum.)
    y = y + 0.5 * np.sin(3 * x)
    jgp, tgp = _pair(lambda k: 1.0 * k.Matern32Kernel(1.0), **models)
    jgp.compute(x, yerr)
    ref = sp_minimize(jgp.nll, jgp.get_parameter_vector(), jac=jgp.grad_nll,
                      args=(y,))
    tgp.compute(x, yerr)
    res = optimize.minimize(tgp, y, method="dense", device="cpu")
    assert res.success, res
    _close(res.fun, jgp.nll(res.x, y), "objective at the port's optimum")
    _close(res.fun, ref.fun, "optimum against scipy", rtol=1e-8)

    # GP.compute / recompute forward their keyword arguments to the solver.
    calls = []

    class OptionSolver(BasicSolver):
        def compute(self, x, yerr, jitter=0.0):
            calls.append(jitter)
            super(OptionSolver, self).compute(x, np.sqrt(yerr ** 2 + jitter))

    tgp = george_tpu_torch.GP(1.0 * tk.Matern32Kernel(1.0),
                              solver=OptionSolver, device="cpu")
    tgp.compute(x, yerr, jitter=0.01)
    ll = tgp.log_likelihood(y)
    jgp = george_tpu.GP(1.0 * jk.Matern32Kernel(1.0))
    jgp.compute(x, np.sqrt(yerr ** 2 + 0.01))
    _close(ll, jgp.log_likelihood(y), "log-likelihood through the option")
    tgp.set_parameter_vector(tgp.get_parameter_vector() + 0.1)
    assert tgp.recompute(jitter=0.02)
    assert calls == [0.01, 0.02]


def test_gp_api_examples(capsys):
    # 01: the first-steps tutorial.
    out = _example("01").main(device="cpu")
    np.random.seed(1234)
    x = 10 * np.sort(np.random.rand(15))
    yerr = 0.2 * np.ones_like(x)
    y = np.sin(x) + yerr * np.random.randn(len(x))
    jgp = george_tpu.GP(np.var(y) * jk.ExpSquaredKernel(0.5))
    jgp.compute(x, yerr)
    _close(out["ll"], jgp.log_likelihood(y), "01 ll", rtol=1e-9)
    _, var = jgp.predict(y, np.linspace(0, 10, 500), return_var=True)
    _close(out["band"], 2 * np.sqrt(var[250]), "01 band", rtol=1e-9)
    ref = sp_minimize(jgp.nll, jgp.get_parameter_vector(), jac=jgp.grad_nll,
                      args=(y,))
    _close(out["scipy_fun"], ref.fun, "01 scipy NLL", rtol=1e-9)
    _close(out["fun"], ref.fun, "01 L-BFGS NLL", rtol=1e-9)
    assert out["evaluations"] > out["nit"] > 0

    # 03: the mixture of GPs.
    out = _example("03").main(device="cpu")
    np.random.seed(42)
    n = 150
    x = np.sort(np.random.uniform(0, 20, n))
    yerr = 0.05 * np.ones(n)
    trend = 0.5 * x
    seasonal = np.sin(2 * np.pi * x / 3.0)
    y = trend + seasonal + yerr * np.random.randn(n)
    k_trend = 100.0 * jk.ExpSquaredKernel(50.0)
    k_seasonal = 2.0 * jk.ExpSine2Kernel(
        gamma=5.0, log_period=np.log(3.0)) * jk.ExpSquaredKernel(100.0)
    jgp = george_tpu.GP(k_trend + k_seasonal)
    jgp.compute(x, yerr)
    _close(out["ll"], jgp.log_likelihood(y), "03 ll", rtol=1e-9)
    for key, k, truth in (("rms_trend", k_trend, trend),
                          ("rms_seasonal", k_seasonal, seasonal)):
        mu = jgp.predict(y, x, return_cov=False, kernel=k)
        _close(out[key], np.sqrt(np.mean((mu - truth) ** 2)), "03 " + key,
               rtol=1e-9)

    # 04: input gradients of the posterior mean, and the ascent.
    ex04 = _example("04")
    out = ex04.main(device="cpu", steps=20)
    np.random.seed(3)
    x_obs = np.random.uniform(-2, 2, 12)
    y_obs = ex04.objective(x_obs) + 0.01 * np.random.randn(12)
    jgp = george_tpu.GP(1.0 * jk.Matern52Kernel(0.5))
    jgp.compute(x_obs, 0.01)
    alpha = jgp.apply_inverse(y_obs)
    t = np.array([[0.3]])
    g = np.asarray(jgp.kernel.get_x1_gradient(t, jgp._x))
    _close(out["grad_mu"], np.einsum("inj,n->j", g, alpha)[0], "04 d mu/dt",
           rtol=1e-9)
    eps = 1e-5
    fd = (jgp.predict(y_obs, (t + eps).ravel(), return_cov=False)[0]
          - jgp.predict(y_obs, (t - eps).ravel(), return_cov=False)[0]) \
        / (2 * eps)
    _close(out["fd"], fd, "04 finite difference", rtol=1e-9)
    assert abs(out["grad_mu"] - out["fd"]) < 1e-5
    for _ in range(20):
        g = np.asarray(jgp.kernel.get_x1_gradient(t, jgp._x))
        t = t + 0.05 * np.einsum("inj,n->j", g, alpha)
    _close(out["t"], t[0, 0], "04 argmax", rtol=1e-9)
    _close(out["mu"], jgp.predict(y_obs, t.ravel(), return_cov=False)[0],
           "04 mean at the argmax", rtol=1e-9)

    # 05: a kernel spec registered at run time, in both packages; the
    # registries are restored after (other tests read them).
    from george_tpu.dsl import specs as jspecs
    from george_tpu_torch.dsl import specs as tspecs

    ex05 = _example("05")
    name = "MyLocalGaussianKernel"
    try:
        out = ex05.main(device="cpu")
        spec = jspecs._parse_spec(yaml.safe_load(ex05.SPEC), "<inline>")
        jspecs.available_kernels()[spec.name] = spec
        k = jk._make_kernel_class(spec)(x0=0.5, log_w=0.1)
        x = np.random.default_rng(0).standard_normal((10, 1))
        _close(out["K"], k.get_value(x), "05 K", rtol=1e-9, atol=1e-15)
        _close(out["gradient"], k.get_gradient(x), "05 gradient", rtol=1e-9,
               atol=1e-15)
        _close(out["x1_gradient"], k.get_x1_gradient(x), "05 x1 gradient",
               rtol=1e-9, atol=1e-15)
    finally:
        for specs, module in ((jspecs, jk), (tspecs, tk)):
            specs.available_kernels().pop(name, None)
            if hasattr(module, name):
                delattr(module, name)

    # 07: the state-space GP at N = 600 against the dense GP.
    out = _example("07").main(device="cpu", n=600)
    rng = np.random.default_rng(42)
    t = np.sort(rng.uniform(0, 100, 600))
    yerr = 0.1 * np.ones(600)
    y = np.sin(t) + 0.3 * np.cos(3.1 * t) + yerr * rng.standard_normal(600)
    jgp = george_tpu.GP(1.0 * jk.Matern32Kernel(2.0)
                        + 0.3 * jk.ExpKernel(0.5))
    jgp.compute(t, yerr)
    _close(out["ll"], jgp.log_likelihood(y), "07 ll", rtol=1e-9)
    _close(out["grad"], jgp.grad_log_likelihood(y), "07 gradient", rtol=1e-7,
           atol=1e-9)
    _close(out["density"], out["ll"], "07 density", rtol=1e-9)
    jgp.compute(t[:500], yerr[:500])
    _close(out["ll_state_space"], jgp.log_likelihood(y[:500]),
           "07 state-space at N = 500", rtol=1e-9)
    assert out["engine"] == "torch_kalman" and out["draws"].shape == (2, 600)
    assert "gradient checks passed" in capsys.readouterr().out


def test_sampler_examples_run():
    def finite(stats):
        return all(bool(torch.all(torch.isfinite(stats[k])))
                   for k in ("mean", "std", "ess", "rhat"))

    out = _example("02").main(device="cpu", chains=4, steps=5)
    assert out["engine"] == "torch_kalman"
    assert finite(out["stats"]) and finite(out["stats_chees"])
    assert out["nuts"].samples.shape == (4, 5, 3)

    out = _example("06").main(device="cpu", particles=64)
    assert out["engine"] == "torch_dense"
    assert bool(torch.all(torch.isfinite(out["result"].particles)))
    assert np.isfinite(out["median"]) and out["result"].num_stages > 0

    out = _example("08").main(device="cpu", chains=4, steps=10)
    assert out["engines"] == ("torch_dense_autograd",) * 2
    assert finite(out["white"]) and finite(out["corr"])
    assert all(np.isfinite(out["location_white"] + out["location_gp"]))

    out = _example("09").main(device="cpu", chains=4, steps=10)
    assert out["engine"] == "torch_dense"
    assert finite(out["stats"]) and out["result"].samples.shape == (4, 10, 5)
