# -*- coding: utf-8 -*-
"""Multi-dimensional inputs with subspace metrics, sampled at scale.

BASELINE config #5: a Matern-3/2 kernel acting on a 2-axis *subspace* of
3-D inputs (axes=[0, 2]; axis 1 is ignored), with a fitted constant mean
and white noise.  Posteriors like this have no 1-D state-space form, so
the sampler rides the fused batched dense value+gradient: on the card one
launch of the hand-written kernel (``csrc/dense_vg.cu``) a gradient for
every chain at once, each chain with its own N x N Cholesky.

On the CPU the same script runs the kernel's plain PyTorch version
(``log_prob.engine`` names it); the math is identical.

Run on the CUDA card (``--device cpu`` for the CPU):
``python examples_torch/09_multidim_subspace_nuts.py``; ``EX_STEPS`` sets
the warmup and the draws (default 200 each).
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


def main(device=None, chains=None, steps=None):
    rng = np.random.default_rng(7)
    n = 128
    x = rng.uniform(-3, 8, (n, 3))
    yerr = 0.22 * np.ones(n)
    y = np.sin(x[:, 0]) + 0.3 * np.cos(x[:, 2]) \
        + yerr * rng.standard_normal(n)

    gp = george.GP(
        1.0 * kernels.Matern32Kernel(metric=[1.0, 2.0], ndim=3,
                                     axes=[0, 2]),
        white_noise=np.log(1e-3), fit_white_noise=True,
        mean=0.0, fit_mean=True, device=device,
    )
    dev = gp.device
    center = torch.as_tensor(gp.get_parameter_vector(), device=dev)

    def log_prior(theta):
        return -0.5 * torch.sum(((theta - center) / 2.0) ** 2)

    # method="dense" is what config-#5 posteriors get from "auto" anyway
    # (no state-space form); the fused batch kernel attaches here.
    log_prob, theta0 = build_gp_log_prob(gp, x, y, yerr, method="dense",
                                         log_prior=log_prior, device=dev)
    print("engine:", log_prob.engine)

    if chains is None:
        chains = 512 if dev.type == "cuda" else 32
    gen = torch.Generator(device=dev).manual_seed(1)
    z0 = theta0[None, :] + 0.1 * torch.randn(
        (chains, len(theta0)), generator=gen, device=dev, dtype=theta0.dtype)
    steps = int(os.environ.get("EX_STEPS", 200)) if steps is None else steps
    res = run_mcmc(log_prob, z0, gen, num_warmup=steps, num_samples=steps,
                   max_depth=4, block_size=25, device=dev)
    stats = summary(res.samples)
    names = gp.get_parameter_names()
    print("{0:>42s} {1:>9s} {2:>8s} {3:>8s}".format(
        "parameter", "mean", "std", "rhat"))
    for i, nm in enumerate(names):
        print("{0:>42s} {1:9.3f} {2:8.3f} {3:8.3f}".format(
            nm, float(stats["mean"][i]), float(stats["std"][i]),
            float(stats["rhat"][i])))
    return dict(engine=log_prob.engine, result=res, stats=stats,
                names=names)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    out = main(parser.parse_args().device)
    # The example's own gate, at its sizes (a run of a few draws, as the
    # tests make, cannot meet it).
    assert float(torch.max(out["stats"]["rhat"])) < 1.1
