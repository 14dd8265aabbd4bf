# -*- coding: utf-8 -*-
"""Sampler diagnostics: split R-hat and effective sample size.

Vehtari et al. 2021 conventions (Stan's split-chain definitions), on
(chains, draws, dim) tensors, returning per-parameter tensors.
"""

import math

import torch

__all__ = ["split_rhat", "effective_sample_size", "summary"]


def _split(samples):
    """(chains, draws, dim) -> (2*chains, draws//2, dim)."""
    half = samples.shape[1] // 2
    return torch.cat([samples[:, :half], samples[:, half:2 * half]], dim=0)


def split_rhat(samples):
    """Split-chain potential scale reduction factor, per parameter."""
    x = _split(torch.as_tensor(samples))
    n = x.shape[1]
    chain_mean = torch.mean(x, dim=1)                        # (m, d)
    chain_var = torch.var(x, dim=1, correction=1)            # (m, d)
    between = n * torch.var(chain_mean, dim=0, correction=1)  # (d,)
    within = torch.mean(chain_var, dim=0)                    # (d,)
    var_est = (n - 1.0) / n * within + between / n
    return torch.sqrt(var_est / within)


def effective_sample_size(samples):
    """Bulk ESS via FFT autocorrelations + Geyer initial monotone sequence."""
    x = _split(torch.as_tensor(samples))
    m, n, _ = x.shape
    chain_mean = torch.mean(x, dim=1, keepdim=True)
    centered = x - chain_mean

    # Per-chain autocovariance via FFT.
    size = int(2 ** math.ceil(math.log2(2 * n)))
    f = torch.fft.rfft(centered, n=size, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=size, dim=1)[:, :n] / n

    chain_var = torch.var(x, dim=1, correction=1)            # (m, d)
    mean_var = torch.mean(chain_var, dim=0)                  # W
    var_plus = mean_var * (n - 1.0) / n \
        + torch.var(chain_mean[:, 0], dim=0, correction=1)   # W + B/n

    rho = 1.0 - (mean_var[None, :] - torch.mean(acov, dim=0)) / var_plus
    rho[0] = 1.0

    # Geyer: sums of adjacent pairs, truncated at first negative, forced
    # monotone non-increasing.
    even = rho[0::2]
    odd = rho[1::2]
    k = min(even.shape[0], odd.shape[0])
    pair = even[:k] + odd[:k]
    pair_positive = pair * (torch.cumprod((pair > 0.0).to(pair.dtype),
                                          dim=0) > 0)
    pair_mono = torch.cummin(
        torch.where(pair_positive > 0, pair_positive,
                    torch.zeros_like(pair_positive)), dim=0
    ).values
    tau = -1.0 + 2.0 * torch.sum(pair_mono, dim=0)
    ess = m * n / torch.clamp(tau, min=1.0 / math.log10(n + 1.0))
    return torch.clamp(ess, max=1.0 * m * n)


def summary(samples):
    """Posterior summary dict: mean, std, ESS, split R-hat per parameter."""
    samples = torch.as_tensor(samples)
    flat = samples.reshape(-1, samples.shape[-1])
    return {
        "mean": torch.mean(flat, dim=0),
        "std": torch.std(flat, dim=0, correction=0),
        "ess": effective_sample_size(samples),
        "rhat": split_rhat(samples),
    }
