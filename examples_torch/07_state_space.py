# -*- coding: utf-8 -*-
"""Exact O(N) state-space GP inference for time series.

The reference's scaling tutorial (docs/tutorials/scaling.rst) compares the
dense and HODLR solvers.  george_tpu_torch adds a third, exact option for
1-D Markovian kernels: the GP as a linear-Gaussian state-space model,
solved by Kalman passes — O(N) likelihoods, gradients, predictions, and
samples with *identical* numerics to the dense path.  On the card every
gradient is one launch of the Kalman value+gradient kernel
(``csrc/kalman_vg.cu``).

Run on the CUDA card (``--device cpu`` for the CPU):
``python examples_torch/07_state_space.py``; ``EX_N`` sets the series'
length (default 20000).
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere without installing

import george_tpu_torch as george
from george_tpu_torch import kernels
from george_tpu_torch.solvers import BasicSolver, StateSpaceSolver
from george_tpu_torch.samplers import build_gp_log_prob


def main(device=None, n=None):
    rng = np.random.default_rng(42)
    n = int(os.environ.get("EX_N", 20000)) if n is None else n
    t = np.sort(rng.uniform(0, 100, n))
    yerr = 0.1 * np.ones(n)
    y = (np.sin(t) + 0.3 * np.cos(3.1 * t)
         + yerr * rng.standard_normal(n))

    kernel = (1.0 * kernels.Matern32Kernel(2.0)
              + 0.3 * kernels.ExpKernel(0.5))

    # GP API with the O(N) solver — same calls, 20k points.
    gp = george.GP(kernel, solver=StateSpaceSolver, device=device)
    dev = gp.device
    t0 = time.time()
    gp.compute(t, yerr)
    ll = gp.log_likelihood(y)
    grad = gp.grad_log_likelihood(y)
    print("N = {0}: log-likelihood {1:.3f} in {2:.3f}s (incl. first calls)"
          .format(n, ll, time.time() - t0))
    print("grad:", grad)

    # Cross-check a subset against the dense solver.
    m = min(500, n)
    gp_d = george.GP(kernel, solver=BasicSolver, device=dev)
    gp_d.compute(t[:m], yerr[:m])
    gp_s = george.GP(kernel, solver=StateSpaceSolver, device=dev)
    gp_s.compute(t[:m], yerr[:m])
    ll_d, ll_s = gp_d.log_likelihood(y[:m]), gp_s.log_likelihood(y[:m])
    print("dense vs state-space at N={0}: {1:.9f} vs {2:.9f}".format(
        m, ll_d, ll_s))

    # The sampler hot path picks this representation automatically.
    log_prob, theta0 = build_gp_log_prob(gp, t, y, yerr,
                                         device=dev)  # method="auto"
    v, g = log_prob.batched_value_and_grad(theta0[None])
    print("batched O(N) posterior density:", float(v[0]))

    # O(N) prior sample.
    s = gp.sample(size=2, generator=torch.Generator(device=dev).manual_seed(0))
    print("prior draws:", s.shape)
    return dict(engine=log_prob.engine, ll=ll, grad=grad, ll_dense=ll_d,
                ll_state_space=ll_s, density=float(v[0]),
                density_grad=g[0].cpu().numpy(), draws=s)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    main(parser.parse_args().device)
