#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""The JAX package's ChEES run on ``chip_smoke.py``'s main path, on the CPU.

    JAX_PLATFORMS=cpu python tools/chees_reference.py

Same data (``bench.py``: seed 42, N = 1000, ``sin(x)`` + 0.1 noise), model
(``1.0 * Matern32Kernel(1.0)`` with a fitted log white noise), prior (sigma 2
around theta0), initial spread and schedule (150 warmup iterations, leapfrog
cap 64) as the port's main path in ``chip_smoke.py``, with 512 chains in
place of 16384 so that it runs on a CPU.  For each seed it prints one JSON line with the
draws' mean acceptance, the adapted step size and the leapfrogs per draw:
the reference values ``chip_smoke.py`` holds the port's run to.  In
float64, as the JAX package's tests run.
"""

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

N = 1000
WARMUP = 150
MAX_LEAPFROG = 64
SAMPLES = 300
CHAINS = 512
SEEDS = (1, 2, 3)


def main():
    rng = np.random.default_rng(42)
    x = np.sort(rng.uniform(0, 10, N))
    yerr = 0.1 * np.ones(N)
    y = np.sin(x) + yerr * rng.standard_normal(N)
    gp = george.GP(1.0 * kernels.Matern32Kernel(1.0),
                   white_noise=np.log(1e-4), fit_white_noise=True)
    center = jnp.asarray(gp.get_parameter_vector())
    log_prob, theta0 = build_gp_log_prob(
        gp, x, y, yerr,
        log_prior=lambda th: -0.5 * jnp.sum(((th - center) / 2.0) ** 2))
    z0 = jnp.asarray(theta0) + 0.1 * jnp.asarray(
        np.random.default_rng(0).standard_normal((CHAINS, len(theta0))))

    for seed in SEEDS:
        t0 = time.time()
        res = run_mcmc(log_prob, z0, jax.random.PRNGKey(seed),
                       algorithm="chees", num_warmup=WARMUP,
                       num_samples=SAMPLES, num_leapfrog=MAX_LEAPFROG)
        jax.block_until_ready(res.samples)
        print(json.dumps({
            "engine": log_prob.engine, "chains": CHAINS, "seed": seed,
            "draws_accept": float(np.mean(res.accept_prob)),
            "step_size": float(res.step_size),
            "leapfrogs_per_draw": float(np.mean(res.n_leapfrog)),
            "seconds": time.time() - t0,
        }), flush=True)


if __name__ == "__main__":
    main()
