# -*- coding: utf-8 -*-
"""The PyTorch port's DSL, kernels, modeling layer and dense GP against the
JAX package, on the same numpy inputs (port in float64 on the CPU, JAX on
the CPU in x64 as tests/conftest.py sets it)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import george_tpu
from george_tpu import kernels as jk
from george_tpu.dsl import compiler as jcompiler
from george_tpu.dsl.specs import load_specs as jax_load_specs

import george_tpu_torch
from george_tpu_torch import kernels as tk
from george_tpu_torch.dsl import compiler as tcompiler
from george_tpu_torch.dsl.specs import load_specs as torch_load_specs


def _zoo(k):
    """Kernel expressions built from either package's ``kernels`` module."""
    return {
        "exp": lambda: 0.5 * k.ExpKernel(2.0),
        "matern32": lambda: 1.7 * k.Matern32Kernel(0.8),
        "matern52": lambda: 2.0 * k.Matern52Kernel(1.3),
        "expsq_iso2d": lambda: 1.3 * k.ExpSquaredKernel(0.7, ndim=2),
        "matern32_axis2d": lambda: k.Matern32Kernel([0.5, 2.0], ndim=2),
        "matern52_general2d": lambda: 0.8 * k.Matern52Kernel(
            [[1.0, 0.3], [0.3, 2.0]], ndim=2),
        "rq": lambda: k.RationalQuadraticKernel(log_alpha=0.3, metric=1.5),
        "cosine_sum": lambda: 0.3 * k.CosineKernel(log_period=0.7)
        + 1.1 * k.Matern32Kernel(2.0),
        "const_product": lambda: k.ConstantKernel(log_constant=-0.5)
        * k.ExpKernel(1.0) + k.ConstantKernel(log_constant=0.2),
        "linear_order2": lambda: k.LinearKernel(log_gamma2=0.4, order=2.0),
        "poly_local": lambda: k.PolynomialKernel(log_sigma2=0.1, order=3.0)
        + k.LocalGaussianKernel(location=0.5, log_width=0.2),
        "expsine2_dot": lambda: k.ExpSine2Kernel(gamma=1.2, log_period=0.4)
        * k.DotProductKernel(),
    }


def _points(ndim, n=7, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-2, 2, (n, ndim)), rng.uniform(-2, 2, (n + 2, ndim))


def test_specs_match_the_reference():
    ref, mine = jax_load_specs(), torch_load_specs()
    assert sorted(ref) == sorted(mine)
    assert len(mine) == 13
    for name, spec in mine.items():
        assert spec.__dict__ == ref[name].__dict__


@pytest.mark.parametrize("name", sorted(_zoo(tk)))
def test_kernel_values_match_reference(name):
    kt, kj = _zoo(tk)[name](), _zoo(jk)[name]()
    assert kt.get_parameter_names() == kj.get_parameter_names()
    np.testing.assert_array_equal(kt.get_parameter_vector(),
                                  kj.get_parameter_vector())
    assert kt.spec_node() == kj.spec_node() or repr(kt.spec_node()) == \
        repr(kj.spec_node())
    x1, x2 = _points(kt.ndim)
    theta = kj.get_parameter_vector(include_frozen=True)
    ref = np.asarray(jcompiler.kernel_value_fn(kj.spec_node())(
        jnp.asarray(theta), jnp.asarray(x1), jnp.asarray(x2)))
    # Same closed forms in float64: agreement to rounding (1e-12).
    np.testing.assert_allclose(kt.get_value(x1, x2, device="cpu"), ref,
                               rtol=1e-12, atol=1e-12)
    ref_diag = np.asarray(jcompiler.kernel_diag_fn(kj.spec_node())(
        jnp.asarray(theta), jnp.asarray(x1), jnp.asarray(x1[::-1])))
    np.testing.assert_allclose(
        kt.get_value(x1, x1[::-1], diag=True, device="cpu"), ref_diag,
        rtol=1e-12, atol=1e-12)


def test_radial_gradient_is_finite_at_zero_distance():
    # Autograd through sqrt(r2) is NaN at r2 = 0; the DSL's r2 derivative
    # keeps the metric gradient finite there (it equals the reference's).
    x = np.array([[0.0], [0.0], [1.0]])
    for k in (tk.ExpKernel(1.3), tk.Matern32Kernel(0.7)):
        node = k.spec_node()
        th = torch.tensor(k.get_parameter_vector(), requires_grad=True)
        K = tcompiler.kernel_value_fn(node)(th, torch.as_tensor(x),
                                            torch.as_tensor(x))
        g, = torch.autograd.grad(K.sum(), th)
        assert torch.all(torch.isfinite(g))


def test_parameter_api_matches_reference():
    def build(k, kernels):
        gp = k.GP(1.5 * kernels.Matern32Kernel(
            metric=1.0, metric_bounds=[(-2.0, 2.0)]), mean=0.3,
            fit_mean=True, white_noise=np.log(1e-3), fit_white_noise=True,
            **({"device": "cpu"} if k is george_tpu_torch else {}))
        gp.freeze_parameter("kernel:k1:log_constant")
        gp.set_parameter("mean:value", -0.2)
        return gp

    gt, gj = build(george_tpu_torch, tk), build(george_tpu, jk)
    for include_frozen in (False, True):
        assert gt.get_parameter_names(include_frozen) == \
            gj.get_parameter_names(include_frozen)
        np.testing.assert_array_equal(gt.get_parameter_vector(include_frozen),
                                      gj.get_parameter_vector(include_frozen))
        assert gt.get_parameter_bounds(include_frozen) == \
            gj.get_parameter_bounds(include_frozen)
    np.testing.assert_array_equal(gt.unfrozen_mask, gj.unfrozen_mask)
    gt.thaw_parameter("kernel:k1:log_constant")
    gj.thaw_parameter("kernel:k1:log_constant")
    np.testing.assert_array_equal(gt.unfrozen_mask, gj.unfrozen_mask)
    v = np.array([0.1, -3.0, 0.4, 2.5])   # last one out of bounds
    gt.set_parameter_vector(v)
    gj.set_parameter_vector(v)
    assert gt.log_prior() == gj.log_prior() == -np.inf


def test_smart_pow_negative_base():
    # C's pow(-2.0, 2.0) is 4.0; the integral exponent must not NaN.
    out = tcompiler._smart_pow(torch.tensor([-2.0, -0.5], dtype=torch.float64),
                               2.0)
    np.testing.assert_array_equal(out.numpy(), [4.0, 0.25])
    assert tcompiler._smart_pow(-3.0, 3.0) == -27.0
    x = np.array([[-1.5], [0.5], [2.0]])
    kt = tk.LinearKernel(log_gamma2=0.0, order=3.0)
    kj = jk.LinearKernel(log_gamma2=0.0, order=3.0)
    np.testing.assert_allclose(kt.get_value(x, device="cpu"),
                               kj.get_value(x), rtol=1e-14)
    assert np.all(np.isfinite(kt.get_value(x, device="cpu")))


def test_anchor_log_likelihood():
    # The published correctness anchor (the JAX package's test_gp.py).
    np.random.seed(1234)
    x = np.sort(np.random.uniform(0, 10, 50000))
    yerr = 0.1 * np.ones_like(x)
    y = np.sin(x)
    gp = george_tpu_torch.GP(np.var(y) * tk.ExpSquaredKernel(1.0),
                             device="cpu")
    gp.compute(x[:100], yerr[:100])
    assert abs(gp.log_likelihood(y[:100]) - 133.946394912) < 1e-6


def test_gp_likelihood_and_gradient_match_reference():
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(0, 10, 60))
    yerr = 0.1 * np.ones_like(x)
    y = np.sin(x) + yerr * rng.standard_normal(60)

    def build(pkg, kernels, **kw):
        return pkg.GP(0.9 * kernels.Matern52Kernel(1.3)
                      + 0.2 * kernels.CosineKernel(log_period=0.5),
                      mean=0.1, fit_mean=True, white_noise=np.log(1e-3),
                      fit_white_noise=True, **kw)

    gt = build(george_tpu_torch, tk, device="cpu")
    gj = build(george_tpu, jk)
    gt.compute(x, yerr)
    gj.compute(x, yerr)
    # Dense Cholesky in float64 on both sides: 1e-10 relative.
    np.testing.assert_allclose(gt.log_likelihood(y), gj.log_likelihood(y),
                               rtol=1e-10)
    np.testing.assert_allclose(gt.grad_log_likelihood(y),
                               gj.grad_log_likelihood(y),
                               rtol=1e-7, atol=1e-9)


def test_entry_points_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        george_tpu_torch.GP(tk.ExpKernel(1.0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tk.ExpKernel(1.0).get_value(np.zeros((2, 1)))


@pytest.mark.gpu
def test_gp_on_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(0, 10, 80))
    y = np.sin(x)
    out = []
    for device in ("cpu", "cuda"):
        gp = george_tpu_torch.GP(1.2 * tk.Matern32Kernel(0.9),
                                 white_noise=np.log(1e-3),
                                 fit_white_noise=True, device=device)
        gp.compute(x, 0.1)
        out.append((gp.log_likelihood(y), gp.grad_log_likelihood(y)))
    # float64 on both devices: 1e-10 relative.
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-10)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-8, atol=1e-10)
