# -*- coding: utf-8 -*-
"""The port's ChEES sampler layer against the JAX package.

Every building block gets the same numpy inputs on both sides and must agree
to 1e-10 (float64 on both: the port on the CPU, JAX on the CPU in x64 as
tests/conftest.py sets it).  The end-to-end ChEES runs draw different random
numbers in the two packages, so they agree in distribution only.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import george_tpu
from george_tpu import kernels as jk
from george_tpu.samplers import adaptation as jadapt
from george_tpu.samplers import chees as jchees
from george_tpu.samplers import diagnostics as jdiag
from george_tpu.samplers import build_gp_log_prob as jax_build
from george_tpu.samplers import run_mcmc as jax_run

import george_tpu_torch
from george_tpu_torch import kernels as tk
from george_tpu_torch.convert import load_reference_parameters
from george_tpu_torch.ops import kalman
from george_tpu_torch.samplers import adaptation as tadapt
from george_tpu_torch.samplers import chees as tchees
from george_tpu_torch.samplers import diagnostics as tdiag
from george_tpu_torch.samplers import build_gp_log_prob as torch_build
from george_tpu_torch.samplers import run_mcmc as torch_run

# One intra-op thread: the tensors here are small, and the suite's workers
# run side by side (several threads each cost more than they gain).
torch.set_num_threads(1)

RTOL = 1e-10


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _close(mine, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(mine), np.asarray(ref), rtol=rtol,
                               atol=atol)


def test_halton_sequence():
    i = np.concatenate([np.arange(300), [2 ** 20 + 7, 2 ** 31 - 1,
                                         2 ** 32 - 1]])
    # Integer bit reversal, then one float32 division: bitwise equal.
    np.testing.assert_array_equal(
        tchees.halton_sequence(torch.as_tensor(i)).numpy(),
        np.asarray(jchees.halton_sequence(jnp.asarray(i, jnp.uint32))))


def test_traj_update():
    rng = np.random.default_rng(0)
    mine = tchees.traj_init(_t(0.3))
    ref = jchees.traj_init(jnp.asarray(0.3))
    for g, eps in zip(50.0 * rng.standard_normal(30),
                      rng.uniform(0.05, 0.5, 30)):
        mine = tchees.traj_update(mine, _t(g), _t(eps), 64)
        ref = jchees.traj_update(ref, jnp.asarray(g), jnp.asarray(eps), 64)
        for a, b in zip(mine, ref):
            _close(a, b, atol=1e-12)


def test_dual_averaging():
    rng = np.random.default_rng(1)
    mine, ref = tadapt.da_init(_t(0.25)), jadapt.da_init(jnp.asarray(0.25))
    for a in rng.uniform(0, 1, 40):
        mine = tadapt.da_update(mine, _t(a), target=0.651)
        ref = jadapt.da_update(ref, jnp.asarray(a), target=0.651)
        for x, y in zip(mine, ref):
            _close(x, y, atol=1e-12)


@pytest.mark.parametrize("dense", [False, True])
def test_welford(dense):
    rng = np.random.default_rng(2)
    mine = tadapt.welford_init(3, dense=dense)
    ref = jadapt.welford_init(3, dense=dense)
    for _ in range(5):
        zs = rng.standard_normal((17, 3)) @ np.diag([1.0, 3.0, 0.2]) + 1.5
        mine = tadapt.welford_update_batch(mine, _t(zs))
        ref = jadapt.welford_update_batch(ref, jnp.asarray(zs))
        for x, y in zip(mine, ref):
            _close(x, y, atol=1e-12)
    _close(tadapt.welford_variance(mine), jadapt.welford_variance(ref))


def test_build_schedule():
    for n in (0, 10, 19, 20, 40, 150, 151, 500, 1000):
        for mine, ref in zip(tadapt.build_schedule(n),
                             jadapt.build_schedule(n)):
            np.testing.assert_array_equal(mine, ref)


def test_ess_and_rhat():
    rng = np.random.default_rng(3)
    chains, draws, dim = 6, 101, 3
    x = np.zeros((chains, draws, dim))
    noise = rng.standard_normal((chains, draws, dim))
    for t in range(1, draws):              # AR(1) draws, phi = 0.1, 0.6, 0.9
        x[:, t] = np.array([0.1, 0.6, 0.9]) * x[:, t - 1] + noise[:, t]
    x[0] += 0.3                             # one shifted chain for R-hat
    _close(tdiag.effective_sample_size(_t(x)),
           jdiag.effective_sample_size(jnp.asarray(x)))
    _close(tdiag.split_rhat(_t(x)), jdiag.split_rhat(jnp.asarray(x)))
    mine, ref = tdiag.summary(_t(x)), jdiag.summary(jnp.asarray(x))
    for key in ("mean", "std", "ess", "rhat"):
        _close(mine[key], ref[key])


def _dataset(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    yerr = 0.1 * np.ones(n)
    y = np.sin(x) + yerr * rng.standard_normal(n)
    return x, y, yerr


def test_chees_posterior_matches_jax():
    # tests/test_pallas_kalman.py's end-to-end ChEES case on both sides.
    x, y, yerr = _dataset()
    gj = george_tpu.GP(1.0 * jk.Matern32Kernel(1.0))
    gt = george_tpu_torch.GP(1.0 * tk.Matern32Kernel(1.0), device="cpu")
    lp_j, theta0 = jax_build(gj, x, y, yerr)
    lp_t, _ = torch_build(gt, x, y, yerr, device="cpu")
    z0 = np.asarray(theta0) + 0.1 * np.random.default_rng(4).standard_normal(
        (16, 2))
    ref = jax_run(lp_j, jnp.asarray(z0), jax.random.PRNGKey(0),
                  algorithm="chees", num_warmup=40, num_samples=40)
    res = torch_run(lp_t, _t(z0), 0, algorithm="chees", num_warmup=40,
                    num_samples=40, device="cpu")
    mean = tdiag.summary(res.samples)["mean"].numpy()
    ref_mean = np.asarray(jdiag.summary(ref.samples)["mean"])
    assert res.samples.shape == (16, 40, 2)
    assert np.all(np.isfinite(res.samples.numpy()))
    # Different random streams: the reference's own loose MC bound.
    assert np.all(np.abs(mean - ref_mean) < 0.5)
    # Both packages run the draws at dual averaging's averaged step size,
    # smaller than the warmup's, so the draws accept above the 0.651 target.
    assert float(res.accept_prob.mean()) > 0.651
    assert float(np.mean(ref.accept_prob)) > 0.651
    # Every gradient of the run went through the fused value+gradient.
    assert res.num_evaluations >= 40 + 40


def test_run_mcmc_options():
    x, y, yerr = _dataset(n=16)
    gt = george_tpu_torch.GP(1.0 * tk.Matern32Kernel(1.0), device="cpu")
    lp_t, theta0 = torch_build(gt, x, y, yerr, device="cpu")
    z0 = theta0 + 0.1 * torch.randn(4, 2, generator=torch.Generator()
                                    .manual_seed(0), dtype=theta0.dtype)
    calls = []
    res = torch_run(lp_t, z0, 1, algorithm="chees", num_warmup=6,
                    num_samples=5, block_size=2, warmup_block_size=3,
                    progress=lambda *a: calls.append(a), device="cpu")
    assert calls == [("warmup", 3, 6), ("warmup", 6, 6), ("sampling", 2, 5),
                     ("sampling", 4, 5), ("sampling", 5, 5)]
    assert res.samples.shape == (4, 5, 2) and res.n_leapfrog.shape == (4, 5)
    # Same seed, same draws.
    again = torch_run(lp_t, z0, 1, algorithm="chees", num_warmup=6,
                      num_samples=5, device="cpu")
    np.testing.assert_array_equal(again.samples.numpy(), res.samples.numpy())
    for algorithm in ("nuts", "hmc"):
        res = torch_run(lp_t, z0, 0, algorithm=algorithm, num_warmup=2,
                        num_samples=2, max_depth=2, num_leapfrog=2,
                        device="cpu")
        assert res.samples.shape == (4, 2, 2)
        assert np.all(np.isfinite(res.samples.numpy()))
    with pytest.raises(ValueError, match="unknown algorithm"):
        torch_run(lp_t, z0, 0, algorithm="mala", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            torch_run(lp_t, z0, 0, algorithm="chees")


def test_load_reference_parameters():
    def gp(pkg, k, **kw):
        g = pkg.GP(0.8 * k.Matern32Kernel(1.1) + 0.3 * k.ExpKernel(0.4),
                   mean=0.2, fit_mean=True, white_noise=np.log(1e-3),
                   fit_white_noise=True, **kw)
        return g

    gj = gp(george_tpu, jk)
    gj.set_parameter_vector(np.array([0.05, -6.0, -0.1, 0.7, -1.0, 0.2]))
    gj.freeze_parameter("kernel:k2:k2:metric:log_M_0_0")
    gt = gp(george_tpu_torch, tk, device="cpu")
    load_reference_parameters(
        gt, gj.get_parameter_names(include_frozen=True),
        np.asarray(gj.get_parameter_vector(include_frozen=True)),
        np.asarray(gj.unfrozen_mask))
    assert gt.get_parameter_names() == gj.get_parameter_names()
    np.testing.assert_array_equal(gt.get_parameter_vector(include_frozen=True),
                                  gj.get_parameter_vector(include_frozen=True))
    np.testing.assert_array_equal(gt.unfrozen_mask, gj.unfrozen_mask)
    x, y, yerr = _dataset(n=40, seed=5)
    gj.compute(x, yerr)
    gt.compute(x, yerr)
    # Dense float64 Cholesky on both sides: 1e-10 relative.
    _close(gt.log_likelihood(y), gj.log_likelihood(y))
    with pytest.raises(ValueError, match="names differ"):
        load_reference_parameters(
            gt, gj.get_parameter_names(include_frozen=True)[::-1],
            np.asarray(gj.get_parameter_vector(include_frozen=True)),
            np.asarray(gj.unfrozen_mask))


@pytest.mark.gpu
def test_chees_on_cuda_goes_through_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    x, y, yerr = _dataset(n=200)
    gt = george_tpu_torch.GP(1.0 * tk.Matern32Kernel(1.0),
                             white_noise=np.log(1e-4), fit_white_noise=True)
    lp_t, theta0 = torch_build(gt, x, y, yerr, dtype=torch.float32)
    assert lp_t.engine == "cuda_kalman"
    z0 = theta0 + 0.1 * torch.randn(
        256, len(theta0), generator=torch.Generator("cuda").manual_seed(0),
        device="cuda", dtype=theta0.dtype)
    launches = kalman.kalman_vg.launches
    res = torch_run(lp_t, z0, 0, algorithm="chees", num_warmup=40,
                    num_samples=40)
    assert kalman.kalman_vg.launches - launches == res.num_evaluations
    assert torch.all(torch.isfinite(res.samples))
