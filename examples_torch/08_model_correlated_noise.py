# -*- coding: utf-8 -*-
"""Model fitting with correlated noise (reference docs/tutorials/model.rst).

A non-linear mean model (a Gaussian dip: amplitude, location, log-width) is
fit to data whose noise is correlated.  First the classic mistake — assume
the noise is white — then the fix: model the covariance structure with a GP
and sample the *joint* posterior over mean-model and kernel hyperparameters.

The reference runs two emcee loops around its stateful GP object
(model.rst:174-186, 224-240).  Here both posteriors are single batched
densities (the mean model through the ``torch_value`` hook) and NUTS
samples a hundred chains in one batch.  A mean model of three parameters
does not fit the fused kernels' parameter layout, so both densities take
the plain autograd dense route, on the card as on the CPU.

Run on the CUDA card (``--device cpu`` for the CPU):
``python examples_torch/08_model_correlated_noise.py``; ``EX_CHAINS`` and
``EX_STEPS`` set the chains (default 128) and the warmup and draws
(default 500 each).
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
from george_tpu_torch.modeling import ConstantModel, Model
from george_tpu_torch.samplers import build_gp_log_prob, run_mcmc, summary


class GaussianFeature(Model):
    """amp * exp(-0.5 (t - location)^2 / sigma^2)  (model.rst:66-72)."""

    parameter_names = ("amp", "location", "log_sigma2")

    def get_value(self, t):
        return self.amp * np.exp(
            -0.5 * (t.flatten() - self.location) ** 2
            * np.exp(-self.log_sigma2)
        )

    def torch_value(self, params, t):
        amp, loc, log_s2 = params[0], params[1], params[2]
        return amp * torch.exp(
            -0.5 * (t[:, 0] - loc) ** 2 * torch.exp(-log_s2)
        )


TRUTH = dict(amp=-1.0, location=0.1, log_sigma2=np.log(0.4))


def generate_data(params, n, rng=(-5, 5), seed=1234, device=None):
    np.random.seed(seed)
    truth_gp = george.GP(0.1 * kernels.ExpSquaredKernel(3.3), device=device)
    t = rng[0] + np.diff(rng) * np.sort(np.random.rand(n))
    # The JAX example's truth_gp.sample(t): one draw from the prior's
    # covariance (jittered) on the global numpy stream, so that the data
    # are the same.
    cov = truth_gp.get_matrix(t)
    cov.flat[::n + 1] += 1.25e-12
    y = np.random.multivariate_normal(np.zeros(n), cov)
    y += GaussianFeature(**params).get_value(t)
    yerr = 0.05 + 0.05 * np.random.rand(n)
    y += yerr * np.random.randn(n)
    return t, y, yerr


def make_models(y, device=None):
    """The two models: the white-noise one and the correlated-noise GP."""
    # 1) Assume white noise: mean model over an EmptyKernel GP (the
    #    TrivialSolver path) — biased, overconfident `location`.
    wn = george.GP(
        mean=GaussianFeature(**TRUTH), fit_mean=True,
        white_noise=np.log(0.5 ** 2), fit_white_noise=True, device=device,
    )
    # 2) Model the correlated noise with a Matern-3/2 GP and marginalize
    #    (model.rst:196-240); the location posterior widens to the truth.
    #    The GP absorbs the white component, so the extra white-noise
    #    amplitude is bounded below (the bounds prior keeps NUTS off the
    #    improper exp(wn) -> 0 plateau).  The reference bounds the
    #    mean-model parameters (model.rst's flat prior over amp in
    #    (-10,10), location in (-5,5), width in (0,3)): without them
    #    `location` is unidentified once the GP absorbs the dip and NUTS
    #    wanders an improper plateau.  The modeling protocol's bounds ARE
    #    the prior here, exactly as in the reference.
    feature = GaussianFeature(
        bounds=dict(amp=(-10.0, 10.0), location=(-5.0, 5.0),
                    log_sigma2=(np.log(1e-3), np.log(3.0))),
        **TRUTH,
    )
    gp = george.GP(
        np.var(y) * kernels.Matern32Kernel(10.0),
        mean=feature, fit_mean=True,
        white_noise=ConstantModel(np.log(0.5 ** 2), bounds=[(-12.0, 5.0)]),
        fit_white_noise=True, device=device,
    )
    return wn, gp


def sample_posterior(gp, t, y, yerr, seed, label, chains, steps):
    # The dense route for both models: the Matern-3/2 GP would take the
    # state-space route under "auto", and the plain sequential filter is a
    # Python loop of N steps (some 24,000 operations a value+gradient at
    # N = 50, against some 700 for the dense density; the same exact
    # likelihood).
    log_prob, theta0 = build_gp_log_prob(gp, t, y, yerr, method="dense",
                                         device=gp.device)
    gen = torch.Generator(device=gp.device).manual_seed(seed)
    z0 = theta0 + 0.1 * torch.randn((chains, len(theta0)), generator=gen,
                                    device=gp.device, dtype=theta0.dtype)
    # Blocked execution bounds each stretch of work between progress
    # points; identical math and random stream to one block.
    res = run_mcmc(log_prob, z0, gen, num_warmup=steps, num_samples=steps,
                   max_depth=8, block_size=50, device=gp.device)
    stats = summary(res.samples)
    print("--", label)
    for i, name in enumerate(gp.get_parameter_names()):
        print("  {0:32s} mean={1:+.3f} std={2:.3f} ess={3:.0f} rhat={4:.3f}"
              .format(name, float(stats["mean"][i]), float(stats["std"][i]),
                      float(stats["ess"][i]), float(stats["rhat"][i])))
    return stats, res, log_prob.engine


def main(device=None, chains=None, steps=None):
    chains = int(os.environ.get("EX_CHAINS", 128)) if chains is None \
        else chains
    steps = int(os.environ.get("EX_STEPS", 500)) if steps is None else steps
    t, y, yerr = generate_data(TRUTH, 50, device=device)
    wn, gp = make_models(y, device=device)

    white, white_res, white_engine = sample_posterior(
        wn, t, y, yerr, 42, "white-noise model", chains, steps)
    # The second run's generator: the first's seed folded with 1.
    corr, corr_res, corr_engine = sample_posterior(
        gp, t, y, yerr, 42 * 1000 + 1, "correlated-noise (GP) model",
        chains, steps)

    names = gp.get_parameter_names()
    i_loc = names.index("mean:location")
    print("location: truth={0:+.3f}  white={1:+.3f}+/-{2:.3f}  "
          "gp={3:+.3f}+/-{4:.3f}".format(
              TRUTH["location"],
              float(white["mean"][1]), float(white["std"][1]),
              float(corr["mean"][i_loc]), float(corr["std"][i_loc])))
    return dict(white=white, corr=corr, white_result=white_res,
                corr_result=corr_res, engines=(white_engine, corr_engine),
                location_white=(float(white["mean"][1]),
                                float(white["std"][1])),
                location_gp=(float(corr["mean"][i_loc]),
                             float(corr["std"][i_loc])),
                location_gp_rhat=float(corr["rhat"][i_loc]))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    main(parser.parse_args().device)
