# -*- coding: utf-8 -*-
"""Posterior inference over GP hyperparameters: NUTS, HMC and ChEES-HMC.

Quick start::

    log_prob, theta0 = build_gp_log_prob(gp, x, y, yerr)
    z0 = theta0 + 0.1 * torch.randn(4096, len(theta0), device=theta0.device)
    result = run_mcmc(log_prob, z0, 0, algorithm="nuts", max_depth=4,
                      num_warmup=500, num_samples=500, block_size=100)
    stats = summary(result.samples, rank_normalized=True)
"""

from .logprob import build_gp_log_prob, traceable_model_fn
from .hmc import HMCState, new_state, leapfrog, hmc_step
from .nuts import nuts_step, NUTSInfo
from .chees import chees_step, ChEESInfo
from .mcmc import run_mcmc, MCMCResult
from .diagnostics import split_rhat, effective_sample_size, summary

__all__ = [
    "build_gp_log_prob", "traceable_model_fn",
    "HMCState", "new_state", "leapfrog", "hmc_step",
    "nuts_step", "NUTSInfo",
    "chees_step", "ChEESInfo",
    "run_mcmc", "MCMCResult",
    "split_rhat", "effective_sample_size", "summary",
]
