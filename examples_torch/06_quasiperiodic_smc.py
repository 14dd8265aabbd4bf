# -*- coding: utf-8 -*-
"""SMC over the multimodal period posterior of a quasi-periodic GP.

Benchmark config #3: an ExpSine2 x ExpSquared kernel on an irregularly
sampled oscillating series.  The period posterior has harmonic aliases;
tempered SMC populates the modes where a single HMC chain would stick.  On
the card every target evaluation of the particle cloud is one launch of
the dense value+gradient kernel (``csrc/dense_vg.cu``).

Run on the CUDA card (``--device cpu`` for the CPU):
``python examples_torch/06_quasiperiodic_smc.py``; ``EX_PARTICLES`` sets
the cloud's size (default 2000).
"""
import argparse
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere without installing

import george_tpu_torch as george
from george_tpu_torch import kernels
from george_tpu_torch.samplers import build_gp_log_prob
from george_tpu_torch.samplers.smc import run_smc


def main(device=None, particles=None):
    rng = np.random.default_rng(8)
    n = 80
    true_period = 2.3
    x = np.sort(rng.uniform(0, 18, n))
    yerr = 0.15 * np.ones(n)
    y = np.sin(2 * np.pi * x / true_period) \
        + yerr * rng.standard_normal(n)

    kernel = 1.0 * kernels.ExpSine2Kernel(
        gamma=3.0, log_period=np.log(2.0)
    ) * kernels.ExpSquaredKernel(100.0)
    gp = george.GP(kernel, white_noise=np.log(1e-4), fit_white_noise=True,
                   device=device)
    dev = gp.device
    log_prob, theta0 = build_gp_log_prob(gp, x, y, yerr, device=dev)
    dim = len(theta0)

    # Initial cloud: broad Gaussian around the rough guess.
    scale = torch.as_tensor([1.0, 1.0, 0.8, 1.0, 1.0][:dim], device=dev,
                            dtype=theta0.dtype)

    def log_init(z):
        d = (z - theta0) / scale
        return -0.5 * torch.sum(d * d, dim=-1) - torch.sum(torch.log(scale)) \
            - 0.5 * dim * math.log(2 * math.pi)

    gen = torch.Generator(device=dev).manual_seed(0)
    n_particles = int(os.environ.get("EX_PARTICLES", 2000)) \
        if particles is None else particles
    particles0 = theta0 + scale * torch.randn(
        (n_particles, dim), generator=gen, device=dev, dtype=theta0.dtype)
    # (This run uses the default random-walk mutations; passing
    # mutation="hmc" would swap in gradient-based Metropolis-HMC instead —
    # better decorrelation per step on smooth posteriors.)
    res = run_smc(log_prob, log_init, particles0, gen, num_mutations=8,
                  device=dev)

    names = gp.get_parameter_names()
    i_period = next(
        i for i, n in enumerate(names) if n.endswith("log_period")
    )
    periods = np.exp(res.particles[:, i_period].double().cpu().numpy())
    median = float(np.median(periods))
    print("stages: {0}, acceptance: {1:.2f}, logZ: {2:.1f}".format(
        int(res.num_stages), float(res.acceptance),
        float(res.log_evidence)))
    print("period posterior: median {0:.3f} (true {1})".format(
        median, true_period))
    hist, edges = np.histogram(periods, bins=30)
    for h, lo in zip(hist, edges):
        if h > 20:
            print("  mode near P={0:.2f}: {1} particles".format(lo, h))
    return dict(engine=log_prob.engine, result=res, median=median,
                true_period=true_period)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    main(parser.parse_args().device)
