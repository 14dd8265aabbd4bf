# -*- coding: utf-8 -*-
"""The port's associative-scan filter against the JAX package's.

``ops/state_space.kalman_loglike_parallel`` and the
``method="state_space_parallel"`` density of ``build_gp_log_prob`` run in
float64 on the CPU; the reference is the JAX package's
``state_space_loglike_fn(node, method="parallel")`` and its own
``state_space_parallel`` density, in float64 on the CPU
(tests/conftest.py).  Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import george_tpu
from george_tpu import kernels as jk
from george_tpu.ops import state_space as jss
from george_tpu.samplers import build_gp_log_prob as jax_build

import george_tpu_torch
from george_tpu_torch import kernels as tk
from george_tpu_torch.ops import state_space as tss
from george_tpu_torch.samplers import build_gp_log_prob as torch_build

from test_torch_kalman import _dataset, _thetas, _zoo


def _torch_ll_and_grad(kernel, thetas, x, y, v, filter_ll):
    terms = tss.extract_terms(kernel.spec_node())
    th = torch.as_tensor(thetas).requires_grad_(True)
    ll = filter_ll(terms, th, torch.as_tensor(np.diff(x)), torch.as_tensor(y),
                   torch.as_tensor(v))
    g, = torch.autograd.grad(ll.sum(), th)
    return ll.detach().numpy(), g.numpy()


def _case(name, n):
    x, y, _ = _dataset(n=n, seed=21)
    thetas = _thetas(_zoo(tk)[name]().get_parameter_vector(), 3, 0.2,
                     seed=22)
    v = 0.01 + 0.005 * np.random.default_rng(23).uniform(size=n)
    return x, y, v, thetas


# JAX compiles its scan for each kernel and length (seconds each on a
# CPU, ~10 s for the six-state sum at N = 48): two small cases, one and two
# terms; the density test below takes a longer series.
@pytest.mark.parametrize("name,n", [("exp", 1), ("const_plus", 6)])
def test_parallel_filter_matches_jax(name, n):
    x, y, v, thetas = _case(name, n)
    ll_j = jss.state_space_loglike_fn(_zoo(jk)[name]().spec_node(),
                                      method="parallel")
    ref, ref_g = jax.jit(jax.vmap(jax.value_and_grad(ll_j),
                                  in_axes=(0, None, None, None)))(
        jnp.asarray(thetas), jnp.asarray(x), jnp.asarray(y), jnp.asarray(v))
    ll, g = _torch_ll_and_grad(_zoo(tk)[name](), thetas, x, y, v,
                               tss.kalman_loglike_parallel)
    # The same scan in float64 on both sides: 1e-10 relative.
    np.testing.assert_allclose(ll, np.asarray(ref), rtol=1e-10)
    np.testing.assert_allclose(g, np.asarray(ref_g), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("n", [1, 2, 5, 48])
@pytest.mark.parametrize("name", sorted(_zoo(tk)))
def test_parallel_filter_matches_sequential(name, n):
    x, y, v, thetas = _case(name, n)
    ll, g = _torch_ll_and_grad(_zoo(tk)[name](), thetas, x, y, v,
                               tss.kalman_loglike_parallel)
    ll_s, g_s = _torch_ll_and_grad(_zoo(tk)[name](), thetas, x, y, v,
                                   tss.kalman_loglike)
    # The sequential filter is held to the JAX package's scan
    # (tests/test_torch_kalman.py); the scan reorders its arithmetic.
    np.testing.assert_allclose(ll, ll_s, rtol=1e-10)
    np.testing.assert_allclose(g, g_s, rtol=1e-8, atol=1e-8)


def test_combine_is_associative():
    rng = np.random.default_rng(24)
    n, D = 7, 3
    x = np.sort(rng.uniform(0, 5, n))
    kernel = 2.0 * tk.Matern52Kernel(1.3)
    terms = tss.extract_terms(kernel.spec_node())
    th = torch.as_tensor(kernel.get_parameter_vector())[None]
    fm = tss._FilterMachine(terms, th)
    Phi, Q, Pinf = fm.systems(fm.sig_rates(th), torch.as_tensor(np.diff(x)))
    r = torch.as_tensor(rng.standard_normal((n, 1)))
    v = torch.full((n, 1), 0.02, dtype=torch.float64)
    e = tss.filter_elements(fm, Phi, Q, Pinf, r, v)
    assert all(a.shape[:2] == (n, 1) for a in e)
    assert e[0].shape[-2:] == (D, D)

    def el(k):
        return tuple(a[k] for a in e)

    left = tss.combine(tss.combine(el(1), el(2)), el(3))
    right = tss.combine(el(1), tss.combine(el(2), el(3)))
    for a, b in zip(left, right):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)
    # The scan's prefixes are the left-to-right products.
    scanned = tss.associative_scan(tss.combine, e)
    acc = el(0)
    for k in range(1, n):
        acc = tss.combine(acc, el(k))
    for a, b in zip(acc, scanned):
        np.testing.assert_allclose(b[-1].numpy(), a.numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_parallel_density_matches_jax():
    name = "matern32"
    x, y, yerr = _dataset(n=16, seed=25)

    def gp(pkg, k, **kw):
        return pkg.GP(_zoo(k)[name](), mean=0.1, fit_mean=True,
                      white_noise=np.log(1e-3), fit_white_noise=True, **kw)

    lp_j, theta0 = jax_build(gp(george_tpu, jk), x, y, yerr,
                             method="state_space_parallel")
    lp_t, theta0_t = torch_build(gp(george_tpu_torch, tk, device="cpu"), x,
                                 y, yerr, method="state_space_parallel",
                                 device="cpu")
    np.testing.assert_array_equal(theta0_t.numpy(), np.asarray(theta0))
    # The batched value+gradient is the fused Kalman engine's (its plain
    # version on the CPU), as the JAX package attaches its Pallas kernel
    # for either method.
    assert lp_t.engine == "torch_kalman"
    thetas = _thetas(theta0, 4, 0.2, seed=26)
    ref_lp, ref_g = jax.jit(jax.vmap(jax.value_and_grad(lp_j)))(
        jnp.asarray(thetas))
    th = torch.as_tensor(thetas).requires_grad_(True)
    lp = lp_t(th)
    g, = torch.autograd.grad(lp.sum(), th)
    # float64 on both sides: 1e-10 relative, gradients 1e-8.
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(ref_lp),
                               rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=1e-8,
                               atol=1e-8)
    lp_b, g_b = lp_t.batched_value_and_grad(torch.as_tensor(thetas))
    np.testing.assert_allclose(lp_b.numpy(), np.asarray(ref_lp), rtol=1e-9)
    np.testing.assert_allclose(g_b.numpy(), np.asarray(ref_g), rtol=1e-8,
                               atol=1e-8)
