# -*- coding: utf-8 -*-
"""The port's fused Kalman value+gradient against the JAX package.

The port's plain version (``ops/kalman.py``: the batched filter with the
gradient from autograd) runs in float64 on the CPU; the JAX reference is
``vmap(value_and_grad(log_prob))`` over its sequential scan filter, in
float64 on the CPU (tests/conftest.py), and in one case the Pallas kernel
itself in interpret mode.  Inputs are made with numpy from a seed and handed
to both packages as numpy.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import george_tpu
from george_tpu import config as jconfig
from george_tpu import kernels as jk
from george_tpu.samplers import build_gp_log_prob as jax_build

import george_tpu_torch
from george_tpu_torch import _build
from george_tpu_torch import kernels as tk
from george_tpu_torch.ops import kalman
from george_tpu_torch.samplers import build_gp_log_prob as torch_build

# One intra-op thread: the tensors here are small, and the suite's workers
# run side by side (several threads each cost more than they gain).
torch.set_num_threads(1)


def _zoo(k):
    """tests/test_state_space.py's KERNELS, from either package."""
    return {
        "exp": lambda: 0.5 * k.ExpKernel(2.0),
        "matern32": lambda: 1.7 * k.Matern32Kernel(0.8),
        "matern52": lambda: 2.0 * k.Matern52Kernel(1.3),
        "cosine_plus": lambda: 0.3 * k.CosineKernel(log_period=0.7)
        + 1.1 * k.Matern32Kernel(2.0),
        "const_plus": lambda: k.ConstantKernel(log_constant=-0.5)
        + k.ExpKernel(1.0),
        "sum3": lambda: 1.7 * k.Matern32Kernel(0.8)
        + 0.5 * k.ExpKernel(2.0) + 2.0 * k.Matern52Kernel(1.3),
    }


def _dataset(n=48, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    x = offset + np.sort(rng.uniform(0, 10, n))
    yerr = 0.1 * np.ones(n)
    y = np.sin(x - offset) + yerr * rng.standard_normal(n)
    return x, y, yerr


def _thetas(theta0, count, scale, seed):
    rng = np.random.default_rng(seed)
    return np.asarray(theta0)[None, :] + scale * rng.standard_normal(
        (count, len(theta0)))


def _jax_vg(log_prob, thetas):
    lp, g = jax.jit(jax.vmap(jax.value_and_grad(log_prob)))(
        jnp.asarray(thetas))
    return np.asarray(lp), np.asarray(g)


def _torch_vg(log_prob, thetas):
    lp, g = log_prob.batched_value_and_grad(torch.as_tensor(thetas))
    return lp.numpy(), g.numpy()


@pytest.mark.parametrize("name", sorted(_zoo(tk)))
def test_vg_matches_jax_scan_path(name):
    x, y, yerr = _dataset(n=40, seed=1)

    def gp(pkg, k, **kw):
        return pkg.GP(_zoo(k)[name](), mean=0.1, fit_mean=True,
                      white_noise=np.log(1e-3), fit_white_noise=True, **kw)

    gj = gp(george_tpu, jk)
    gt = gp(george_tpu_torch, tk, device="cpu")
    lp_j, theta0 = jax_build(gj, x, y, yerr)
    lp_t, theta0_t = torch_build(gt, x, y, yerr, device="cpu")
    np.testing.assert_array_equal(theta0_t.numpy(), np.asarray(theta0))
    assert lp_t.engine == "torch_kalman"
    thetas = _thetas(theta0, 4, 0.2, seed=2)
    ref_lp, ref_g = _jax_vg(lp_j, thetas)
    # Same filter arithmetic in float64 on both sides: 1e-9 relative.
    lp, g = _torch_vg(lp_t, thetas)
    np.testing.assert_allclose(lp, ref_lp, rtol=1e-9)
    np.testing.assert_allclose(g, ref_g, rtol=1e-8, atol=1e-8)
    # The scalar log_prob (autograd of the plain filter) agrees as well.
    np.testing.assert_allclose(lp_t(torch.as_tensor(thetas)).numpy(), ref_lp,
                               rtol=1e-9)

    # make_kalman_vg itself: every parameter of the full vector [mean |
    # white noise | kernel] is active and unbounded here, so its (ll, grad)
    # is the reference log_prob's value and gradient.
    # Its plain version carries the gradient in forward mode, as the
    # kernel does: the JAX package's value and gradient at rtol 1e-10.
    vg = kalman.make_kalman_vg(gt.kernel.spec_node(), x, y, yerr ** 2, 1, 1,
                               tuple(range(thetas.shape[1])))
    ll, g = vg(torch.as_tensor(thetas))
    np.testing.assert_allclose(ll.numpy(), ref_lp, rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-10,
                               atol=1e-10 * np.abs(ref_g).max())


def test_bounds_and_prior():
    x, y, yerr = _dataset()

    def build(pkg, k, prior, **kw):
        gp = pkg.GP(1.0 * k.Matern32Kernel(metric=1.0,
                                           metric_bounds=[(-2.0, 2.0)]), **kw)
        return (jax_build if pkg is george_tpu else torch_build)(
            gp, x, y, yerr, log_prior=prior, **kw)

    lp_j, theta0 = build(george_tpu, jk, lambda th: -0.5 * jnp.sum(th ** 2))
    lp_t, _ = build(george_tpu_torch, tk,
                    lambda th: -0.5 * torch.sum(th ** 2), device="cpu")
    thetas = np.stack([np.asarray(theta0), np.asarray(theta0)])
    thetas[1, -1] = 5.0                          # out of bounds
    lp, g = _torch_vg(lp_t, thetas)
    ref_lp, ref_g = _jax_vg(lp_j, thetas)
    # float64 on both sides: 1e-9 relative.
    np.testing.assert_allclose(lp[0], ref_lp[0], rtol=1e-9)
    np.testing.assert_allclose(g[0], ref_g[0], rtol=1e-8, atol=1e-8)
    assert lp[1] == ref_lp[1] == -np.inf
    # Out of bounds the gradient is the prior's alone (exactly -theta).
    np.testing.assert_array_equal(g[1], -thetas[1])


def test_frozen_parameters():
    x, y, yerr = _dataset()

    def build(pkg, k, **kw):
        gp = pkg.GP(2.0 * k.ExpKernel(1.5), **kw)
        gp.kernel.freeze_parameter("k1:log_constant")
        return (jax_build if pkg is george_tpu else torch_build)(
            gp, x, y, yerr, **kw)

    lp_j, theta0 = build(george_tpu, jk)
    lp_t, theta0_t = build(george_tpu_torch, tk, device="cpu")
    assert len(theta0) == len(theta0_t) == 1
    thetas = np.linspace(-0.5, 0.5, 4)[:, None]
    ref_lp, ref_g = _jax_vg(lp_j, thetas)
    lp, g = _torch_vg(lp_t, thetas)
    # float64 on both sides: 1e-9 relative.
    np.testing.assert_allclose(lp, ref_lp, rtol=1e-9)
    np.testing.assert_allclose(g, ref_g, rtol=1e-8, atol=1e-8)


def test_large_epoch_dt_precision():
    # float32 resolution at t ~ 2.45e6 is ~0.25, far coarser than the
    # cadence: the gaps are differenced in float64 BEFORE the cast.
    x, y, yerr = _dataset(n=64, seed=3, offset=2.45e6)
    gt = george_tpu_torch.GP(1.0 * tk.Matern32Kernel(1.0), device="cpu")
    gj = george_tpu.GP(1.0 * jk.Matern32Kernel(1.0))
    lp_t, theta0 = torch_build(gt, x, y, yerr, device="cpu")
    lp_j, _ = jax_build(gj, x - x[0], y, yerr)        # small-offset oracle
    thetas = _thetas(theta0.numpy(), 4, 0.1, seed=4)
    ref_lp, ref_g = _jax_vg(lp_j, thetas)
    lp, g = _torch_vg(lp_t, thetas)
    # Gaps of 2.45e6-offset times carry ~1e-10 relative rounding in float64.
    np.testing.assert_allclose(lp, ref_lp, rtol=1e-8)
    np.testing.assert_allclose(g, ref_g, rtol=1e-6, atol=1e-6)
    # The float32 plain version sees the float64-differenced gaps too: its
    # error is float32 rounding of the filter, not of the epochs.
    lp32, g32 = lp_t.batched_value_and_grad(torch.as_tensor(thetas).float())
    np.testing.assert_allclose(lp32.numpy(), ref_lp, rtol=1e-4, atol=5e-2)
    np.testing.assert_allclose(g32.numpy(), ref_g, rtol=1e-3, atol=5e-2)


def test_against_the_pallas_kernel_in_interpret_mode():
    x, y, yerr = _dataset(n=32, seed=5)

    def gp(pkg, k, **kw):
        return pkg.GP(1.0 * k.Matern32Kernel(1.0), white_noise=np.log(1e-4),
                      fit_white_noise=True, **kw)

    old = jconfig.pallas_kalman
    jconfig.pallas_kalman = "always"
    try:
        lp_j, theta0 = jax_build(gp(george_tpu, jk), x, y, yerr)
        assert lp_j.engine == "pallas_kalman"
        thetas = _thetas(theta0, 5, 0.2, seed=6)
        ref_lp, ref_g = (np.asarray(a) for a in
                         lp_j.batched_value_and_grad(jnp.asarray(thetas)))
    finally:
        jconfig.pallas_kalman = old
    lp_t, _ = torch_build(gp(george_tpu_torch, tk, device="cpu"), x, y, yerr,
                          device="cpu")
    lp, g = _torch_vg(lp_t, thetas)
    # The Pallas kernel computes in float32: the reference's own kernel
    # tolerances (tests/test_pallas_kalman.py).
    np.testing.assert_allclose(lp, ref_lp, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(g, ref_g, rtol=1e-3, atol=1e-2)


def test_wrapper_checks_and_dispatch():
    x, y, yerr = _dataset(n=16)
    node = tk.Matern32Kernel(1.0).spec_node()
    vg = kalman.make_kalman_vg(node, x, y, yerr ** 2, 1, 1, (0, 1, 2))
    theta = torch.zeros(3, 3, dtype=torch.float64)
    dt, ys, v = vg.series(theta)
    # The CUDA wrapper never takes a CPU tensor.
    with pytest.raises(ValueError, match="CUDA"):
        kalman.kalman_vg(vg.spec, theta, dt, ys, v)
    launches = kalman.kalman_vg.launches
    ll, g = vg(theta)                       # CPU tensor: the plain version
    assert kalman.kalman_vg.launches == launches
    assert ll.shape == (3,) and g.shape == (3, 3)
    with pytest.raises(ValueError, match=r"\(B, 3\)"):
        vg(torch.zeros(3, 4, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32 or float64"):
        vg(torch.zeros(3, 3, dtype=torch.float16))
    with pytest.raises(ValueError, match="longer than"):
        kalman.make_kalman_vg(node, np.arange(kalman.MAX_N + 1.0),
                              np.zeros(kalman.MAX_N + 1),
                              np.ones(kalman.MAX_N + 1), 0, 0, (0,))


def test_series_longer_than_the_kernel_takes(caplog):
    # The cap is the reference's (pallas_kalman.MAX_N): one kernel streams
    # every series up to it, past the 32768 of the reference's SMEM kernel.
    assert kalman.MAX_N == 1 << 22
    n = 32769
    x, y, yerr = _dataset(n=n, seed=9)
    x = x * (n / 10.0 / 40.0)                 # gaps of ~0.025 length scales
    gt = george_tpu_torch.GP(1.0 * tk.Matern32Kernel(1.0), device="cpu")
    with caplog.at_level(logging.WARNING, logger="george_tpu_torch"):
        lp_t, theta0 = torch_build(gt, x, y, yerr, device="cpu")
    assert not caplog.records
    assert lp_t.engine == "torch_kalman"
    assert hasattr(lp_t, "batched_value_and_grad")
    lp_j, _ = jax_build(george_tpu.GP(1.0 * jk.Matern32Kernel(1.0)), x, y,
                        yerr)
    thetas = _thetas(theta0.numpy(), 2, 0.1, seed=10)
    ref = np.asarray(jax.jit(jax.vmap(lp_j))(jnp.asarray(thetas)))
    with torch.no_grad():
        lp = lp_t(torch.as_tensor(thetas)).numpy()
    # The same filter arithmetic in float64 over 32769 steps: 1e-9 relative.
    np.testing.assert_allclose(lp, ref, rtol=1e-9)


def test_entry_points_raise_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    x, y, yerr = _dataset(n=16)
    gp = george_tpu_torch.GP(1.0 * tk.Matern32Kernel(1.0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_build(gp, x, y, yerr)
    # The HODLR route is ported (a tree of no levels at this N: the leaves
    # alone); an unknown method raises.
    lp, _ = torch_build(gp, x, y, yerr, method="hodlr", device="cpu")
    assert lp.engine == "hodlr"
    with pytest.raises(ValueError, match="unknown method"):
        torch_build(gp, x, y, yerr, method="bogus", device="cpu")


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    x, y, yerr = _dataset(n=200, seed=7)
    cases = []
    for name, make in sorted(_zoo(tk).items()):
        th_k = make().get_parameter_vector(include_frozen=True)
        vg = kalman.make_kalman_vg(make().spec_node(), x, y, yerr ** 2, 1, 1,
                                   tuple(range(len(th_k) + 2)))
        cases.append((name, vg, th_k))
    # Every instantiation at once (one nvcc each, in parallel).
    _build.build_many([vg.spec.instance(dt) for _, vg, _ in cases
                       for dt in (torch.float32, torch.float64)])
    for name, vg, th_k in cases:
        base = np.concatenate([[0.1, np.log(1e-3)], th_k])
        theta = torch.as_tensor(_thetas(base, 300, 0.2, seed=8))
        ll_ref, g_ref = vg(theta)                       # plain, float64
        launches = kalman.kalman_vg.launches
        for dtype, rtol, atol in ((torch.float64, 1e-9, 1e-9),
                                  (torch.float32, 1e-4, 1e-2)):
            ll, g = vg(theta.to("cuda", dtype))
            torch.cuda.synchronize()
            # float64: formula agreement; float32: the reference's own
            # kernel tolerances (tests/test_pallas_kalman.py).
            np.testing.assert_allclose(ll.double().cpu().numpy(),
                                       ll_ref.numpy(), rtol=rtol, atol=atol,
                                       err_msg=name)
            np.testing.assert_allclose(g.double().cpu().numpy(),
                                       g_ref.numpy(), rtol=10 * rtol,
                                       atol=atol, err_msg=name)
        assert kalman.kalman_vg.launches == launches + 2
