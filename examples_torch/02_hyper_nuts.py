# -*- coding: utf-8 -*-
"""Hyperparameter posteriors with in-framework NUTS.

Replaces the reference's external emcee loop (docs/tutorials/hyper.rst)
with vectorized NUTS: tens of chains in one batch, windowed adaptation,
ESS/R-hat diagnostics — all on the card.  The Matern-3/2 posterior takes
the state-space route: on the card every gradient is one launch of the
Kalman value+gradient kernel (``csrc/kalman_vg.cu``).

Run on the CUDA card (``--device cpu`` for the CPU):
``python examples_torch/02_hyper_nuts.py``; ``EX_STEPS`` sets the warmup
and the draws (default 400 each).
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere without installing

import george_tpu_torch as george
from george_tpu_torch import kernels
from george_tpu_torch.samplers import build_gp_log_prob, run_mcmc, summary


def main(device=None, steps=None, chains=64):
    np.random.seed(1234)
    n = 100
    x = np.sort(np.random.uniform(0, 10, n))
    yerr = 0.1 * np.ones(n)
    truth = george.GP(0.5 * kernels.Matern32Kernel(1.5), device=device)
    # The JAX example's truth.sample(x): one draw from the prior's
    # covariance (jittered) on the global numpy stream, so that the data
    # are the same.
    cov = truth.get_matrix(x)
    cov.flat[::n + 1] += 1.25e-12
    y = np.random.multivariate_normal(np.zeros(n), cov) \
        + yerr * np.random.randn(n)

    gp = george.GP(
        1.0 * kernels.Matern32Kernel(1.0),
        white_noise=np.log(1e-4), fit_white_noise=True, device=device,
    )
    dev = gp.device

    # Weakly-informative Gaussian prior: the log-white-noise direction is
    # an improper flat tail to -inf once the jitter is negligible, and no
    # sampler mixes on it without a prior.
    center = torch.as_tensor(gp.get_parameter_vector(), device=dev)

    def log_prior(theta):
        return -0.5 * torch.sum(((theta - center) / 3.0) ** 2)

    log_prob, theta0 = build_gp_log_prob(gp, x, y, yerr,
                                         log_prior=log_prior, device=dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    z0 = theta0 + 0.1 * torch.randn((chains, len(theta0)), generator=gen,
                                    device=dev, dtype=theta0.dtype)
    steps = int(os.environ.get("EX_STEPS", 400)) if steps is None else steps
    res = run_mcmc(log_prob, z0, gen, num_warmup=steps, num_samples=steps,
                   block_size=100, device=dev)

    stats = summary(res.samples)
    names = gp.get_parameter_names()
    for i, name in enumerate(names):
        print("{0:28s} mean={1:+.3f} std={2:.3f} ess={3:.0f} rhat={4:.3f}"
              .format(name, float(stats["mean"][i]), float(stats["std"][i]),
                      float(stats["ess"][i]), float(stats["rhat"][i])))
    print("divergence fraction:", float(res.diverging.double().mean()))

    # The same posterior with ChEES-HMC — the accelerator-native sampler
    # (shared adapted trajectory, whole batch in lockstep).
    gen_c = torch.Generator(device=dev).manual_seed(0)
    res_c = run_mcmc(log_prob, z0, gen_c, algorithm="chees",
                     num_warmup=steps, num_samples=steps, block_size=100,
                     device=dev)
    stats_c = summary(res_c.samples)
    for i, name in enumerate(names):
        print("[chees] {0:20s} mean={1:+.3f} std={2:.3f} ess={3:.0f}"
              .format(name, float(stats_c["mean"][i]),
                      float(stats_c["std"][i]), float(stats_c["ess"][i])))
    return dict(engine=log_prob.engine, names=names, nuts=res, chees=res_c,
                stats=stats, stats_chees=stats_c)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    main(parser.parse_args().device)
