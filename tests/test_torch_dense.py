# -*- coding: utf-8 -*-
"""The port's dense sampler route against the JAX package.

The JAX reference is its own plain oracle: ``vmap(value_and_grad(log_prob))``
of the ``xla_dense`` route, in float64 on the CPU (tests/conftest.py).  The
port runs in float64 on the CPU: its plain dense ``log_prob`` (autograd) and
the plain version of the fused engine (``ops/dense.py``,
``dense_vg_torch``) behind ``batched_value_and_grad``.  Inputs are made with
numpy from a seed and handed to both packages as numpy.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import george_tpu
from george_tpu import kernels as jk
from george_tpu.samplers import build_gp_log_prob as jax_build

import george_tpu_torch
from george_tpu_torch import config as tconfig
from george_tpu_torch import kernels as tk
from george_tpu_torch.convert import load_reference_parameters
from george_tpu_torch.ops import dense
from george_tpu_torch.samplers import build_gp_log_prob as torch_build
from george_tpu_torch.samplers import run_mcmc as torch_run

# One intra-op thread: the tensors here are small, and the suite's workers
# run side by side (several threads each cost more than they gain).
torch.set_num_threads(1)

# float64 on both sides, the same closed forms: ll to 1e-10, gradients to
# 1e-8 (autograd through the Cholesky against JAX's).
LL_RTOL, G_RTOL, G_ATOL = 1e-10, 1e-8, 1e-10


def _dataset(n=40, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 8, (n, d))
    yerr = 0.1 * np.ones(n)
    y = np.sin(x[:, 0]) + yerr * rng.standard_normal(n)
    return x, y, yerr


def _config5(k, **kw):
    """benchmarks/config5.py's GP, from either package."""
    return dict(kernel=1.0 * k.Matern32Kernel(metric=[1.0, 2.0], ndim=3,
                                              axes=[0, 2]),
                white_noise=np.log(1e-3), fit_white_noise=True, mean=0.0,
                fit_mean=True, **kw)


def _zoo(k):
    """(GP keyword arguments, parameter to freeze or None, N)."""
    wn = dict(white_noise=np.log(1e-3), fit_white_noise=True)
    return {
        "expsq_iso": (dict(kernel=1.3 * k.ExpSquaredKernel(0.7, ndim=3),
                           **wn), None, 30),
        "matern52_frozen": (dict(kernel=2.0 * k.Matern52Kernel(metric=1.5,
                                                               ndim=3)),
                            "kernel:k1:log_constant", 21),
        "sum_product": (dict(kernel=0.5 * k.ExpSquaredKernel(
            metric=[0.6, 1.2], ndim=3, axes=[0, 1])
            + k.ConstantKernel(log_constant=-0.5, ndim=3)
            * k.Matern32Kernel(metric=2.0, ndim=3, axes=[2]), **wn),
            None, 30),
        "rational_quadratic": (dict(kernel=k.RationalQuadraticKernel(
            log_alpha=0.3, metric=[1.5, 0.7, 2.0], ndim=3), mean=0.2,
            fit_mean=True, **wn), None, 30),
        "non_stationary": (dict(kernel=0.8 * k.ExpKernel(metric=1.1, ndim=3)
                                + k.LinearKernel(log_gamma2=2.0, order=1.0,
                                                 ndim=3, axes=[0]), **wn),
                           None, 30),
        "block_window": (dict(kernel=k.Matern32Kernel(
            metric=1.4, ndim=3, axes=[1], block=[(1.0, 6.0)])
            + 0.3 * k.ExpSquaredKernel(2.0, ndim=3), **wn), None, 30),
    }


def _pair(kwargs_of, freeze=None):
    """The same GP in both packages."""
    gj = george_tpu.GP(**kwargs_of(jk))
    gt = george_tpu_torch.GP(device="cpu", **kwargs_of(tk))
    if freeze:
        gj.freeze_parameter(freeze)
        gt.freeze_parameter(freeze)
    return gj, gt


def _thetas(theta0, count, scale, seed):
    rng = np.random.default_rng(seed)
    return np.asarray(theta0)[None, :] + scale * rng.standard_normal(
        (count, len(theta0)))


def _jax_vg(log_prob, thetas):
    lp, g = jax.jit(jax.vmap(jax.value_and_grad(log_prob)))(
        jnp.asarray(thetas))
    return np.asarray(lp), np.asarray(g)


def _check(lp_t, lp_j, thetas):
    ref_lp, ref_g = _jax_vg(lp_j, thetas)
    lp, g = lp_t.batched_value_and_grad(torch.as_tensor(thetas))
    np.testing.assert_allclose(lp.numpy(), ref_lp, rtol=LL_RTOL)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=G_RTOL, atol=G_ATOL)
    th = torch.as_tensor(thetas).requires_grad_(True)
    lp2 = lp_t(th)
    g2, = torch.autograd.grad(lp2.sum(), th)
    np.testing.assert_allclose(lp2.detach().numpy(), ref_lp, rtol=LL_RTOL)
    np.testing.assert_allclose(g2.numpy(), ref_g, rtol=G_RTOL, atol=G_ATOL)


def test_config5_matches_jax_dense():
    x, y, yerr = _dataset()
    gj, gt = _pair(_config5)
    lp_j, theta0 = jax_build(gj, x, y, yerr, method="dense")
    lp_t, theta0_t = torch_build(gt, x, y, yerr, method="dense",
                                 device="cpu")
    assert lp_j.engine == "xla_dense" and lp_t.engine == "torch_dense"
    np.testing.assert_array_equal(theta0_t.numpy(), np.asarray(theta0))
    _check(lp_t, lp_j, _thetas(theta0, 6, 0.2, seed=1))
    # "auto" routes a kernel without a state-space form (3-D inputs) the
    # same way.
    lp_a, _ = torch_build(gt, x, y, yerr, device="cpu")
    assert lp_a.engine == "torch_dense"

    # make_dense_batched_vg itself: every parameter active and unbounded,
    # so its (ll, grad) is the reference log_prob's value and gradient.
    thetas = _thetas(theta0, 3, 0.2, seed=2)
    vg = dense.make_dense_batched_vg(gt.kernel.spec_node(), x, y, yerr ** 2,
                                     1, 1, tuple(range(thetas.shape[1])))
    ll, g = vg(torch.as_tensor(thetas))
    ref_lp, ref_g = _jax_vg(lp_j, thetas)
    np.testing.assert_allclose(ll.numpy(), ref_lp, rtol=LL_RTOL)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=G_RTOL, atol=G_ATOL)


@pytest.mark.parametrize("name", sorted(_zoo(tk)))
def test_zoo_matches_jax_dense(name):
    _, freeze, n = _zoo(tk)[name]
    x, y, yerr = _dataset(n=n, seed=3)
    gj, gt = _pair(lambda k: _zoo(k)[name][0], freeze)
    lp_j, theta0 = jax_build(gj, x, y, yerr, method="dense")
    lp_t, _ = torch_build(gt, x, y, yerr, method="dense", device="cpu")
    assert lp_t.engine == "torch_dense"
    if freeze:
        assert len(theta0) == 1
    _check(lp_t, lp_j, _thetas(theta0, 4, 0.15, seed=4))


def test_bounds_prior_and_failed_factorization():
    x, y, yerr = _dataset(n=24)

    def kwargs(k):
        return dict(kernel=2.0 * k.ExpSquaredKernel(
            metric=1.0, metric_bounds=[(-2.0, 2.0)], ndim=3, axes=[1]))

    gj, gt = _pair(kwargs)
    lp_j, theta0 = jax_build(gj, x, y, yerr, method="dense",
                             log_prior=lambda th: -0.5 * jnp.sum(th ** 2))
    lp_t, _ = torch_build(gt, x, y, yerr, method="dense", device="cpu",
                          log_prior=lambda th: -0.5 * torch.sum(th ** 2))
    thetas = np.stack([np.asarray(theta0)] * 3)
    thetas[1, -1] = 5.0                          # out of bounds
    # exp(1000) overflows: the factorization fails (inf - inf) in both.
    thetas[2, 0] = 1000.0
    ref_lp, ref_g = _jax_vg(lp_j, thetas)
    lp, g = lp_t.batched_value_and_grad(torch.as_tensor(thetas))
    np.testing.assert_allclose(lp[0].item(), ref_lp[0], rtol=LL_RTOL)
    np.testing.assert_allclose(g[0].numpy(), ref_g[0], rtol=G_RTOL,
                               atol=G_ATOL)
    assert lp[1] == lp[2] == ref_lp[1] == ref_lp[2] == -np.inf
    # Rejected points: the gradient is the prior's alone (exactly -theta).
    np.testing.assert_array_equal(g[1:].numpy(), -thetas[1:])
    assert float(lp_t(torch.as_tensor(thetas[2]))) == -np.inf
    # The fused engine itself reports the failed factorization as NaN.
    full = np.array(gt.get_parameter_vector(include_frozen=True))
    full = np.stack([full, full])
    full[1, -2] = 1000.0
    ll, grad = lp_t.dense_vg(torch.as_tensor(full))
    assert np.isfinite(ll[0].item()) and np.isnan(ll[1].item())
    assert torch.all(torch.isnan(grad[1]))


def test_reference_parameters_carry_over():
    x, y, yerr = _dataset(n=24, seed=5)
    gj, gt = _pair(_config5)
    gj.set_parameter_vector(np.array([0.3, -5.0, 0.4, 0.2, 0.9]))
    gj.freeze_parameter("mean:value")
    load_reference_parameters(
        gt, gj.get_parameter_names(include_frozen=True),
        np.asarray(gj.get_parameter_vector(include_frozen=True)),
        np.asarray(gj.unfrozen_mask))
    lp_j, theta0 = jax_build(gj, x, y, yerr, method="dense")
    lp_t, theta0_t = torch_build(gt, x, y, yerr, method="dense",
                                 device="cpu")
    np.testing.assert_array_equal(theta0_t.numpy(), np.asarray(theta0))
    assert len(theta0) == 4
    _check(lp_t, lp_j, _thetas(theta0, 3, 0.1, seed=6))


class _Line(george_tpu_torch.modeling.Model):
    """A two-parameter mean (frozen by the GP): no scalar layout."""

    parameter_names = ("m", "b")

    def get_value(self, x):
        return self.m * x[:, 0] + self.b


def test_routing_engines_and_notes(caplog):
    x, y, yerr = _dataset(n=20, d=2)
    gen = dict(kernel=tk.ExpSquaredKernel(metric=[[1.0, 0.1], [0.1, 2.0]],
                                          ndim=2))
    with caplog.at_level(logging.WARNING, logger="george_tpu_torch"):
        # A general metric has no fused form: the plain route, with a note.
        lp, _ = torch_build(george_tpu_torch.GP(device="cpu", **gen), x, y,
                            yerr, method="dense", device="cpu")
        assert lp.engine == "torch_dense_autograd"
        assert not hasattr(lp, "batched_value_and_grad")
        assert any("outside the VPU kernel envelope" in r.getMessage()
                   for r in caplog.records)
        # N above the envelope: the same.
        caplog.clear()
        x2, y2, yerr2 = _dataset(n=dense.MAX_N + 4, d=3)
        lp2, _ = torch_build(george_tpu_torch.GP(device="cpu",
                                                 **_config5(tk)),
                             x2, y2, yerr2, method="dense", device="cpu")
        assert lp2.engine == "torch_dense_autograd"
        assert any("falling back" in r.getMessage() for r in caplog.records)
        # A mean model that is not a scalar: the same, with its own note.
        caplog.clear()
        gm = george_tpu_torch.GP(tk.ExpSquaredKernel(1.0, ndim=3),
                                 mean=_Line(m=0.5, b=0.1), fit_mean=False,
                                 device="cpu")
        lpm, _ = torch_build(gm, *_dataset(n=12), method="dense",
                             device="cpu")
        assert lpm.engine == "torch_dense_autograd"
        assert any("mean model" in r.getMessage() for r in caplog.records)

    # config.engine_log=False silences the notes; "never" attaches nothing.
    old = tconfig.engine_log, tconfig.pallas_dense
    try:
        tconfig.engine_log = False
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="george_tpu_torch"):
            torch_build(george_tpu_torch.GP(device="cpu", **gen), x, y, yerr,
                        method="dense", device="cpu")
        assert not caplog.records
        tconfig.pallas_dense = "never"
        lp3, _ = torch_build(george_tpu_torch.GP(device="cpu",
                                                 **_config5(tk)),
                             *_dataset(n=12), method="dense", device="cpu")
        assert lp3.engine == "torch_dense_autograd"
    finally:
        tconfig.engine_log, tconfig.pallas_dense = old

    # Where the JAX package's router takes its MXU engine (opt-in,
    # 129 <= N <= 512): the blocked engine, "cuda_dense_mxu" on the card and
    # "torch_dense_mxu" on the CPU.
    x3, y3, yerr3 = _dataset(n=130, d=3)
    gp = george_tpu_torch.GP(device="cpu", **_config5(tk))
    old = tconfig.dense_mxu_sampling
    try:
        tconfig.dense_mxu_sampling = True
        lp4, _ = torch_build(gp, x3, y3, yerr3, method="dense", device="cpu")
        assert lp4.engine == "torch_dense_mxu"
        from george_tpu_torch.samplers import logprob
        lo, hi = (torch.as_tensor(a) for a in logprob._bounds_arrays(gp))
        logprob._attach_dense_vg(
            lp4, gp, gp.kernel.spec_node(), x3, y3, yerr3 ** 2,
            torch.as_tensor(gp.get_parameter_vector(include_frozen=True)),
            torch.arange(5), lo, hi, None, torch.device("cuda"))
        assert lp4.engine == "cuda_dense_mxu"
    finally:
        tconfig.dense_mxu_sampling = old


def test_wrapper_checks_and_dispatch():
    x, y, yerr = _dataset(n=12)
    node = _config5(tk)["kernel"].spec_node()
    vg = dense.make_dense_batched_vg(node, x, y, yerr ** 2, 1, 1, (0, 1, 2))
    theta = torch.zeros(2, 5, dtype=torch.float64)
    xs, ys, vs = vg.data(theta)
    with pytest.raises(ValueError, match="CUDA"):
        dense.dense_vg(vg.spec, theta, xs, ys, vs)
    launches = dense.dense_vg.launches
    ll, g = vg(theta)                       # CPU tensor: the plain version
    assert dense.dense_vg.launches == launches
    assert ll.shape == (2,) and g.shape == (2, 3)
    with pytest.raises(ValueError, match=r"\(B, 5\)"):
        vg(torch.zeros(2, 4, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32 or float64"):
        vg(torch.zeros(2, 5, dtype=torch.float16))
    with pytest.raises(ValueError, match="N <= 256"):
        dense.make_dense_batched_vg(node, np.zeros((257, 3)), np.zeros(257),
                                    np.ones(257), 0, 0, (0,))


def test_chees_runs_through_the_dense_engine():
    x, y, yerr = _dataset(n=24, seed=7)
    gt = george_tpu_torch.GP(device="cpu", **_config5(tk))
    lp_t, theta0 = torch_build(gt, x, y, yerr, method="dense", device="cpu")
    assert lp_t.engine == "torch_dense"
    calls = []
    inner = lp_t.batched_value_and_grad

    def counted(z):
        calls.append(z.shape[0])
        return inner(z)

    lp_t.batched_value_and_grad = counted
    z0 = theta0 + 0.1 * torch.as_tensor(
        np.random.default_rng(8).standard_normal((8, len(theta0))))
    res = torch_run(lp_t, z0, 1, algorithm="chees", num_warmup=40,
                    num_samples=40, device="cpu")
    assert res.samples.shape == (8, 40, 5)
    assert torch.all(torch.isfinite(res.samples))
    # Every gradient of the run went through the fused engine.
    assert len(calls) == res.num_evaluations >= 80
    assert float(res.diverging.double().mean()) < 0.05


_F64 = ((torch.float64, 1e-9, 1e-9),)
_BOTH = _F64 + ((torch.float32, 1e-4, 1e-2),)


# N = 40 and 136 pad to 48 and 144 (16 x 16 tiles), 256 fills 16 tiles a
# side; in float64 the tiles sit in shared memory up to N = 208 and in the
# device workspace from 209.
@pytest.mark.gpu
@pytest.mark.parametrize("n,cases", [(40, _BOTH), (136, _BOTH),
                                     (256, _BOTH), (200, _F64), (209, _F64)])
def test_cuda_kernel_matches_plain_version(n, cases):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    x, y, yerr = _dataset(n=n, seed=9)
    node = _config5(tk)["kernel"].spec_node()
    vg = dense.make_dense_batched_vg(node, x, y, yerr ** 2, 1, 1,
                                     (0, 1, 2, 3, 4))
    base = np.array([0.1, np.log(1e-3), 0.0, 0.0, np.log(2.0)])
    theta = torch.as_tensor(_thetas(base, 300, 0.2, seed=10))
    ll_ref, g_ref = vg(theta)                           # plain, float64
    launches = dense.dense_vg.launches
    for dtype, rtol, atol in cases:
        ll, g = vg(theta.to("cuda", dtype))
        torch.cuda.synchronize()
        # float64: formula agreement; float32: the reference's own kernel
        # tolerances (tests/test_pallas_dense.py).
        np.testing.assert_allclose(ll.double().cpu().numpy(), ll_ref.numpy(),
                                   rtol=rtol, atol=atol)
        np.testing.assert_allclose(g.double().cpu().numpy(), g_ref.numpy(),
                                   rtol=10 * rtol, atol=atol)
    assert dense.dense_vg.launches == launches + len(cases)
