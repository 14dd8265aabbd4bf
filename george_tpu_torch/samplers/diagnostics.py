# -*- coding: utf-8 -*-
"""Sampler diagnostics: split R-hat, effective sample size, their
rank-normalized forms and the NUTS trajectory screen.

Vehtari et al. 2021 conventions (Stan's split-chain definitions), on
(chains, draws, dim) tensors, returning per-parameter tensors.
"""

import math

import numpy as np
import torch

__all__ = ["split_rhat", "effective_sample_size", "rank_normalize",
           "trajectory_health", "rank_normalized_rhat", "tail_ess",
           "summary"]


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


def rank_normalize(samples):
    """Rank-normalize draws (Vehtari et al. 2021, eq. 14).

    Pooled ranks across all chains/draws, mapped through the normal
    quantile function with the (r - 3/8)/(S + 1/4) fractional-rank offset.
    Makes R-hat/ESS robust to heavy tails and nonlinear scale.
    """
    x = torch.as_tensor(samples)
    c, n, d = x.shape
    flat = x.reshape(c * n, d)
    # Pooled ranks per parameter (argsort of argsort = 0-based ranks; ties
    # in order of appearance).
    order = torch.argsort(flat, dim=0, stable=True)
    ranks = torch.argsort(order, dim=0, stable=True).to(x.dtype) + 1.0
    z = torch.special.ndtri((ranks - 0.375) / (c * n + 0.25))
    return z.reshape(c, n, d)


def _quantile(flat, q):
    """Per-column quantile of (S, d) draws, linear between order
    statistics (numpy's default); ``q = 0.5`` is the median."""
    s = torch.sort(flat, dim=0).values
    pos = q * (s.shape[0] - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, s.shape[0] - 1)
    frac = pos - lo
    return s[lo] + (s[hi] - s[lo]) * frac


def rank_normalized_rhat(samples):
    """Max of bulk (rank-normalized) and tail (folded rank-normalized)
    split R-hat — the published convergence diagnostic (Vehtari et al.
    2021, "Rank-normalization, folding, and localization").
    """
    x = torch.as_tensor(samples)
    bulk = split_rhat(rank_normalize(x))
    med = _quantile(x.reshape(-1, x.shape[-1]), 0.5)
    tail = split_rhat(rank_normalize(torch.abs(x - med)))
    return torch.maximum(bulk, tail)


def tail_ess(samples):
    """Tail ESS: minimum ESS of the 5% / 95% quantile *indicators*,
    measuring mixing in the distribution tails.  The indicators go to the
    ESS estimator directly — rank-normalizing a binary variable would
    shuffle its ties into noise."""
    x = torch.as_tensor(samples)
    flat = x.reshape(-1, x.shape[-1])
    ess05 = effective_sample_size((x <= _quantile(flat, 0.05)).to(x.dtype))
    ess95 = effective_sample_size((x <= _quantile(flat, 0.95)).to(x.dtype))
    return torch.minimum(ess05, ess95)


def trajectory_health(n_leapfrog, reference=None, expected_mean=None,
                      mean_rtol=0.25, sig_atol=0.25):
    """Screen a NUTS run's trajectory lengths for truncation to
    complete-subtree lengths.

    A sampler whose U-turn vote is corrupted at subtree merges ends its
    trajectories at complete-subtree lengths: on the main path's posterior
    (a natural mean of ~9 leapfrogs) a TPU build of the JAX package once
    ended 46% of its draws at exactly 3 and 34% at exactly 7.  A {3, 7}
    pile-up is NOT an absolute signature — easy low-dimensional posteriors
    legitimately U-turn at 3 leapfrogs — so health is judged against an
    anchor for the *same posterior and step size*:

    :param n_leapfrog: per-draw leapfrog counts (any shape; typically
        ``MCMCResult.n_leapfrog``).
    :param reference: leapfrog counts from a trusted run of the same
        configuration (the per-draw ``persistent=False`` path, a CPU run).
        Healthy iff the mean lengths agree within ``mean_rtol`` (relative)
        and the combined {3, 7} mass agrees within ``sig_atol``
        (absolute).
    :param expected_mean: alternatively, the posterior's known healthy
        mean trajectory length; healthy iff the measured mean is within
        ``mean_rtol`` of it.
    :returns: dict with ``healthy`` (bool; None when no anchor was
        given), ``frac_3``, ``frac_7``, ``frac_truncation_signature``
        (their sum), ``mean_leapfrog``, and the anchor values used.
    """
    def host(a):
        if torch.is_tensor(a):
            a = a.detach().cpu()
        return np.asarray(a).ravel()

    def stats(a):
        return (float(np.mean(a == 3) + np.mean(a == 7)),
                float(np.mean(a)))

    n = host(n_leapfrog)
    sig, mean = stats(n)
    out = {
        "frac_3": float(np.mean(n == 3)),
        "frac_7": float(np.mean(n == 7)),
        "frac_truncation_signature": sig,
        "mean_leapfrog": mean,
    }
    healthy = None
    if reference is not None:
        ref_sig, ref_mean = stats(host(reference))
        out["reference_mean_leapfrog"] = ref_mean
        out["reference_frac_truncation_signature"] = ref_sig
        healthy = (abs(mean - ref_mean) <= mean_rtol * max(ref_mean, 1.0)
                   and abs(sig - ref_sig) <= sig_atol)
    if expected_mean is not None:
        out["expected_mean_leapfrog"] = float(expected_mean)
        ok = abs(mean - expected_mean) <= mean_rtol * max(expected_mean,
                                                          1.0)
        healthy = ok if healthy is None else (healthy and ok)
    out["healthy"] = healthy
    return out


def summary(samples, rank_normalized=False):
    """Posterior summary dict: mean, std, ESS, split R-hat per parameter.

    With ``rank_normalized=True``, additionally: bulk ESS on
    rank-normalized draws (``ess_bulk``), ``ess_tail``, and the
    rank-normalized max-of-bulk-and-tail ``rhat`` (replacing the plain
    split R-hat) — the Vehtari et al. 2021 recommendations.
    """
    samples = torch.as_tensor(samples)
    flat = samples.reshape(-1, samples.shape[-1])
    out = {
        "mean": torch.mean(flat, dim=0),
        "std": torch.std(flat, dim=0, correction=0),
        "ess": effective_sample_size(samples),
        "rhat": split_rhat(samples),
    }
    if rank_normalized:
        out["ess_bulk"] = effective_sample_size(rank_normalize(samples))
        out["ess_tail"] = tail_ess(samples)
        out["rhat"] = rank_normalized_rhat(samples)
    return out
