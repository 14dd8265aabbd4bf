# -*- coding: utf-8 -*-
"""First steps: fit a 1-D GP to noisy data and optimize the hyperparameters.

Parity with the reference's first-steps tutorial (docs/tutorials/first.rst):
model, compute, predict, then scipy optimization of the NLL with the
analytic gradient.

Run on the CUDA card (``--device cpu`` for the CPU):
``python examples_torch/01_first_steps.py``
"""
import argparse
import os
import sys

import numpy as np
from scipy.optimize import minimize

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere without installing

import george_tpu_torch as george
from george_tpu_torch import kernels


def main(device=None):
    np.random.seed(1234)
    x = 10 * np.sort(np.random.rand(15))
    yerr = 0.2 * np.ones_like(x)
    y = np.sin(x) + yerr * np.random.randn(len(x))

    kernel = np.var(y) * kernels.ExpSquaredKernel(0.5)
    gp = george.GP(kernel, device=device)
    gp.compute(x, yerr)
    ll = gp.log_likelihood(y)
    print("initial ln-likelihood: {0:.2f}".format(ll))

    t = np.linspace(0, 10, 500)
    mu, var = gp.predict(y, t, return_var=True)
    band = 2 * np.sqrt(var[250])
    print("predictive band width at t=5: {0:.3f}".format(band))

    result = minimize(gp.nll, gp.get_parameter_vector(),
                      jac=gp.grad_nll, args=(y,))
    gp.set_parameter_vector(result.x)
    print("optimized NLL (scipy): {0:.6f}".format(result.fun))
    print("parameters:", gp.get_parameter_dict())

    # The same optimization as one batched L-BFGS on the GP's device: every
    # evaluation is one call of the density's batched value+gradient (and
    # restarts batch with it — see optimize.minimize(restarts=...)).
    gp.set_parameter_vector(np.log([np.var(y), 0.5]))
    res = george.optimize.minimize(gp, y, device=gp.device)
    print("optimized NLL (on-device L-BFGS): {0:.6f} "
          "in {1} iterations".format(res.fun, res.nit))
    return dict(ll=ll, band=band, scipy_fun=result.fun, scipy_x=result.x,
                fun=res.fun, x=res.x, nit=res.nit,
                evaluations=res.evaluations)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    main(parser.parse_args().device)
