# -*- coding: utf-8 -*-
"""NUTS and HMC over the Kalman kernel on the card.

Every gradient of a run on the state-space route is one launch of the
hand-written Kalman value+gradient kernel, and a seed gives the same draws.
The kernel has no CPU mode: these tests carry the ``gpu`` marker and skip
without a card.
"""

import numpy as np
import pytest
import torch

import george_tpu_torch
from george_tpu_torch import kernels as tk
from george_tpu_torch.ops import kalman
from george_tpu_torch.samplers import build_gp_log_prob, run_mcmc

CHAINS = 1024


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm,opts", [
    ("nuts", dict(max_depth=4)),
    ("nuts", dict(max_depth=4, persistent=False)),
    ("hmc", dict(num_leapfrog=4))])
def test_sampler_on_cuda_goes_through_the_kernel(algorithm, opts):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 10, 200))
    yerr = 0.1 * np.ones(200)
    y = np.sin(x) + yerr * rng.standard_normal(200)
    gp = george_tpu_torch.GP(1.0 * tk.Matern32Kernel(1.0),
                             white_noise=np.log(1e-4), fit_white_noise=True)
    lp, theta0 = build_gp_log_prob(gp, x, y, yerr, dtype=torch.float32)
    assert lp.engine == "cuda_kalman"
    z0 = theta0 + 0.1 * torch.randn(
        CHAINS, len(theta0), generator=torch.Generator("cuda").manual_seed(0),
        device="cuda", dtype=theta0.dtype)
    runs = []
    for _ in range(2):
        launches = kalman.kalman_vg.launches
        res = run_mcmc(lp, z0, 7, algorithm=algorithm, num_warmup=30,
                       num_samples=10, block_size=5, **opts)
        assert kalman.kalman_vg.launches - launches == res.num_evaluations
        assert torch.all(torch.isfinite(res.samples))
        assert res.samples.shape == (CHAINS, 10, len(theta0))
        runs.append(res)
    for field in ("samples", "log_prob", "accept_prob", "n_leapfrog"):
        assert torch.equal(getattr(runs[0], field), getattr(runs[1], field))
    assert runs[0].num_evaluations == runs[1].num_evaluations
