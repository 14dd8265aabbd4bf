# -*- coding: utf-8 -*-
"""Separating kernel-mixture components with predict(kernel=...).

Parity with the reference's mixture tutorial: a long-trend ExpSquared plus a
periodic ExpSine2, predicted separately from one joint fit.

Run on the CUDA card (``--device cpu`` for the CPU):
``python examples_torch/03_mixture_of_gps.py``
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere without installing

import george_tpu_torch as george
from george_tpu_torch import kernels


def main(device=None):
    np.random.seed(42)
    n = 150
    x = np.sort(np.random.uniform(0, 20, n))
    yerr = 0.05 * np.ones(n)
    trend = 0.5 * x
    seasonal = np.sin(2 * np.pi * x / 3.0)
    y = trend + seasonal + yerr * np.random.randn(n)

    k_trend = 100.0 * kernels.ExpSquaredKernel(50.0)
    k_seasonal = 2.0 * kernels.ExpSine2Kernel(gamma=5.0,
                                              log_period=np.log(3.0)) \
        * kernels.ExpSquaredKernel(100.0)
    gp = george.GP(k_trend + k_seasonal, device=device)
    gp.compute(x, yerr)
    ll = gp.log_likelihood(y)
    print("joint ln-likelihood: {0:.2f}".format(ll))

    mu_trend = gp.predict(y, x, return_cov=False, kernel=k_trend)
    mu_seasonal = gp.predict(y, x, return_cov=False, kernel=k_seasonal)
    rms_trend = np.sqrt(np.mean((mu_trend - trend) ** 2))
    rms_seasonal = np.sqrt(np.mean((mu_seasonal - seasonal) ** 2))
    print("trend rms error:    {0:.3f}".format(rms_trend))
    print("seasonal rms error: {0:.3f}".format(rms_seasonal))
    return dict(ll=ll, rms_trend=rms_trend, rms_seasonal=rms_seasonal)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    main(parser.parse_args().device)
