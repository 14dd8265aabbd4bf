#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""The JAX package's ChEES runs on ``chip_smoke.py``'s sampler paths, on the CPU.

    JAX_PLATFORMS=cpu python tools/chees_reference.py [--path kalman|dense]

``--path kalman`` (default): the state-space path.  Same data (``bench.py``:
seed 42, N = 1000, ``sin(x)`` + 0.1 noise), model (``1.0 *
Matern32Kernel(1.0)`` with a fitted log white noise), prior (sigma 2 around
theta0), initial spread and schedule (150 warmup iterations, leapfrog cap
64, 300 draws) as the port's main path in ``chip_smoke.py``.

``--path dense``: the dense path of ``benchmarks/config5.py`` (N = 128
points in 3-D, seed 7; ``1.0 * Matern32Kernel`` on axes 0 and 2 with an
axis-aligned metric, fitted mean and log white noise; prior sigma 2 around
theta0; 150 warmup iterations, leapfrog cap 32), with ``method="dense"``.

Both run fewer chains than the port so that they run on a CPU: the
state-space path 512 chains, the dense path 128 chains and 100 draws (its
batched dense value+gradient is far costlier on a CPU; a seed takes some
5 minutes).  Seeds 1 to 3, in float64 as the JAX package's tests run.  For
each seed
it prints one JSON line with the draws' mean acceptance, the adapted step
size and the leapfrogs per draw: the reference values ``chip_smoke.py``
holds the port's runs to.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_enable_x64", True)

import george_tpu as george  # noqa: E402
from george_tpu import kernels  # noqa: E402
from george_tpu.samplers import build_gp_log_prob, run_mcmc  # noqa: E402

SEEDS = (1, 2, 3)


def kalman_path():
    """(gp, x, y, yerr, method, chains, warmup, draws, leapfrog cap)."""
    rng = np.random.default_rng(42)
    x = np.sort(rng.uniform(0, 10, 1000))
    yerr = 0.1 * np.ones(1000)
    y = np.sin(x) + yerr * rng.standard_normal(1000)
    gp = george.GP(1.0 * kernels.Matern32Kernel(1.0),
                   white_noise=np.log(1e-4), fit_white_noise=True)
    return gp, x, y, yerr, "auto", 512, 150, 300, 64


def dense_path():
    """benchmarks/config5.py's data and model at N = 128."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-3, 8, (128, 3))
    yerr = 0.22 * np.ones(128)
    y = np.sin(x[:, 0]) + 0.3 * np.cos(x[:, 2]) \
        + yerr * rng.standard_normal(128)
    gp = george.GP(
        1.0 * kernels.Matern32Kernel(metric=[1.0, 2.0], ndim=3, axes=[0, 2]),
        white_noise=np.log(1e-3), fit_white_noise=True,
        mean=0.0, fit_mean=True,
    )
    return gp, x, y, yerr, "dense", 128, 150, 100, 32


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", default="kalman", choices=["kalman", "dense"])
    args = parser.parse_args()
    gp, x, y, yerr, method, chains, warmup, draws, cap = (
        kalman_path() if args.path == "kalman" else dense_path())
    center = jnp.asarray(gp.get_parameter_vector())
    log_prob, theta0 = build_gp_log_prob(
        gp, x, y, yerr, method=method,
        log_prior=lambda th: -0.5 * jnp.sum(((th - center) / 2.0) ** 2))
    z0 = jnp.asarray(theta0) + 0.1 * jnp.asarray(
        np.random.default_rng(0).standard_normal((chains, len(theta0))))

    for seed in SEEDS:
        t0 = time.time()
        res = run_mcmc(log_prob, z0, jax.random.PRNGKey(seed),
                       algorithm="chees", num_warmup=warmup,
                       num_samples=draws, num_leapfrog=cap)
        jax.block_until_ready(res.samples)
        print(json.dumps({
            "path": args.path, "engine": log_prob.engine, "chains": chains,
            "seed": seed,
            "draws_accept": float(np.mean(res.accept_prob)),
            "step_size": float(res.step_size),
            "leapfrogs_per_draw": float(np.mean(res.n_leapfrog)),
            "seconds": time.time() - t0,
        }), flush=True)


if __name__ == "__main__":
    main()
