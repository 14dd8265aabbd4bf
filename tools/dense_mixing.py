#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Per-parameter mixing of ChEES on the dense path, on the CPU.

    python tools/dense_mixing.py [chains] [warmup] [draws]

Runs the port's dense route on ``chip_smoke.py``'s config #5 (the same
data, model, prior and initial spread; the first ``chains`` rows of its
4096-chain start) with the plain float64 engine on the CPU, seed 1, leapfrog
cap 32, and prints split R-hat, bulk ESS, the posterior mean and sd, and
the spread of the chain means beside the mean within-chain sd, for each
parameter.  It tells a slowly mixing parameter (chains that agree but are
short) from chains that disagree.  256 chains, 150 + 400 iterations take
about 40 minutes on an 8-core CPU.
"""

import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from george_tpu_torch.samplers import (build_gp_log_prob,  # noqa: E402
                                       effective_sample_size, run_mcmc,
                                       split_rhat)


def main():
    args = [int(a) for a in sys.argv[1:4]]
    chains, warmup, draws = args + [256, 150, 400][len(args):]
    dev = torch.device("cpu")
    x, y, yerr = cs.config5_data()
    gp = cs.config5_gp(dev)
    lp, th0 = build_gp_log_prob(
        gp, x, y, yerr, method="dense", device=dev, dtype=torch.float64,
        log_prior=cs.bench_prior(gp, dev, torch.float64))
    z0 = th0 + 0.1 * torch.as_tensor(np.random.default_rng(0).standard_normal(
        (cs.DENSE_CHAINS, len(th0)))[:chains])
    t0 = time.time()
    res = run_mcmc(lp, z0, 1, algorithm="chees", num_warmup=warmup,
                   num_samples=draws, num_leapfrog=cs.DENSE_MAX_LEAPFROG,
                   block_size=cs.BLOCK, warmup_block_size=cs.BLOCK,
                   device=dev)
    s = res.samples
    flat = s.reshape(-1, s.shape[-1])
    print("engine", lp.engine, "chains", chains, "warmup", warmup, "draws",
          draws, "seconds", time.time() - t0, "evaluations",
          res.num_evaluations)
    print("parameters", gp.get_parameter_names())
    print("split R-hat", split_rhat(s).numpy())
    print("bulk ESS", effective_sample_size(s).numpy())
    print("mean", flat.mean(0).numpy(), "sd", flat.std(0).numpy())
    print("chain-mean sd", s.mean(1).std(0).numpy(), "within-chain sd",
          s.std(1).mean(0).numpy())
    print("draws' acceptance", float(res.accept_prob.mean()), "step size",
          float(res.step_size), "leapfrogs per draw",
          float(res.n_leapfrog.double().mean()))


if __name__ == "__main__":
    main()
