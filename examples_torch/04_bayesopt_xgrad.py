# -*- coding: utf-8 -*-
"""Bayesian-optimization building block: input gradients of the GP mean.

Uses get_x1_gradient (the reference's x1/x2 gradient machinery,
templates/kernels.py:119-133) to climb the posterior-mean surface.

This example checks its gradient against finite differences, whose 1e-5
tolerance assumes double precision: the GP runs in float64 on the card as
on the CPU.

Run on the CUDA card (``--device cpu`` for the CPU):
``python examples_torch/04_bayesopt_xgrad.py``; ``EX_STEPS`` sets the
ascent's steps (default 100).
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


def objective(x):
    return -np.sin(3 * x) - x ** 2 + 0.7 * x


def main(device=None, steps=None):
    np.random.seed(3)
    x_obs = np.random.uniform(-2, 2, 12)
    y_obs = objective(x_obs) + 0.01 * np.random.randn(12)

    gp = george.GP(1.0 * kernels.Matern52Kernel(0.5), device=device,
                   dtype=torch.float64)
    gp.compute(x_obs, 0.01)
    alpha = gp.apply_inverse(y_obs)

    # d mu / d t at a test point, from the kernel's input gradients.
    t = np.array([[0.3]])
    g = gp.kernel.get_x1_gradient(t, gp._x, device=gp.device)  # (1, N, 1)
    grad_mu = float(np.einsum("inj,n->j", g, alpha)[0])
    eps = 1e-5
    mu_p = gp.predict(y_obs, (t + eps).ravel(), return_cov=False)[0]
    mu_m = gp.predict(y_obs, (t - eps).ravel(), return_cov=False)[0]
    fd = (mu_p - mu_m) / (2 * eps)
    print("analytic d mu/dt = {0:+.6f}, finite diff = {1:+.6f}".format(
        grad_mu, fd))
    assert abs(grad_mu - fd) < 1e-5

    # Gradient ascent on the posterior mean finds a local optimum.
    steps = int(os.environ.get("EX_STEPS", 100)) if steps is None else steps
    for _ in range(steps):
        g = gp.kernel.get_x1_gradient(t, gp._x, device=gp.device)
        t = t + 0.05 * np.einsum("inj,n->j", g, alpha)
    mu = gp.predict(y_obs, t.ravel(), return_cov=False)
    print("local argmax of posterior mean: t={0:+.4f}, mu={1:+.4f}".format(
        float(t[0, 0]), float(mu[0])))
    return dict(grad_mu=grad_mu, fd=float(fd), t=float(t[0, 0]),
                mu=float(mu[0]))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    main(parser.parse_args().device)
