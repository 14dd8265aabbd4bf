#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""The JAX package's NUTS run on ``chip_smoke.py``'s main path, on the CPU.

    JAX_PLATFORMS=cpu python tools/nuts_reference.py [--chains 512]

Same data (``bench.py``: seed 42, N = 1000, ``sin(x)`` + 0.1 noise), model
(``1.0 * Matern32Kernel(1.0)`` with a fitted log white noise), prior (sigma
2 around theta0), initial spread and schedule (150 warmup iterations, 300
draws) as the port's NUTS leg in ``chip_smoke.py`` (phase 20):
``run_mcmc(algorithm="nuts", max_depth=4, persistent=True)``, the leg
shape of ``bench.py``.  512 chains, not 16384, so that it runs on a CPU;
seeds 1 to 3, in float64 as the JAX package's tests run.

For each seed it prints one JSON line with the draws' mean acceptance, the
adapted step size, the leapfrogs per draw and the share of draws that ended
at exactly 3 or 7 leapfrogs (``diagnostics.trajectory_health``'s
truncation signature): the reference values ``chip_smoke.py`` holds the
port's NUTS runs to (its ``REF_NUTS_*`` constants).
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
from george_tpu.samplers.diagnostics import trajectory_health  # noqa: E402

SEEDS = (1, 2, 3)
MAX_DEPTH = 4


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--chains", type=int, default=512)
    parser.add_argument("--warmup", type=int, default=150)
    parser.add_argument("--draws", type=int, default=300)
    args = parser.parse_args()

    rng = np.random.default_rng(42)
    x = np.sort(rng.uniform(0, 10, 1000))
    yerr = 0.1 * np.ones(1000)
    y = np.sin(x) + yerr * rng.standard_normal(1000)
    gp = george.GP(1.0 * kernels.Matern32Kernel(1.0),
                   white_noise=np.log(1e-4), fit_white_noise=True)
    center = jnp.asarray(gp.get_parameter_vector())
    log_prob, theta0 = build_gp_log_prob(
        gp, x, y, yerr,
        log_prior=lambda th: -0.5 * jnp.sum(((th - center) / 2.0) ** 2))
    z0 = jnp.asarray(theta0) + 0.1 * jnp.asarray(
        np.random.default_rng(0).standard_normal((args.chains, len(theta0))))

    for seed in SEEDS:
        t0 = time.time()
        res = run_mcmc(log_prob, z0, jax.random.PRNGKey(seed),
                       algorithm="nuts", max_depth=MAX_DEPTH,
                       persistent=True, num_warmup=args.warmup,
                       num_samples=args.draws)
        jax.block_until_ready(res.samples)
        health = trajectory_health(np.asarray(res.n_leapfrog))
        samples = np.asarray(res.samples).reshape(-1, len(theta0))
        print(json.dumps({
            "path": "kalman", "engine": log_prob.engine,
            "chains": args.chains, "seed": seed, "max_depth": MAX_DEPTH,
            "draws_accept": float(np.mean(res.accept_prob)),
            "step_size": float(res.step_size),
            "leapfrogs_per_draw": float(np.mean(res.n_leapfrog)),
            "frac_3_or_7": health["frac_truncation_signature"],
            "divergences": float(np.mean(res.diverging)),
            "mean": samples.mean(0).tolist(),
            "std": samples.std(0).tolist(),
            "seconds": time.time() - t0,
        }), flush=True)


if __name__ == "__main__":
    main()
