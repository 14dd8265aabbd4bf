# -*- coding: utf-8 -*-
"""Warmup adaptation: dual-averaging step size + Welford mass matrix.

Stan-style three-phase windows (fast / expanding-slow / fast).  All
statistics pool across the chain batch — and, when an ``axis_name`` (a
mesh axis, :class:`george_tpu_torch.parallel.mesh.Axis`) is given, across
its ranks — so thousands of (possibly sharded) chains share one step size
and mass matrix.  Scalar states are 0-d tensors on the chains' device, in
their dtype.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from ..parallel.collectives import pmean, psum
from .hmc import kinetic_energy, sample_momentum, velocity

__all__ = [
    "DualAveragingState", "da_init", "da_update",
    "WelfordState", "welford_init", "welford_update_batch",
    "welford_merge_across", "welford_variance", "build_schedule",
    "find_reasonable_step_size", "find_reasonable_step_size_batched",
]


# -- dual averaging (Nesterov 2009, as used by Stan) --------------------------

class DualAveragingState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    h_avg: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor


def da_init(step_size):
    step_size = torch.as_tensor(step_size)
    return DualAveragingState(
        log_step=torch.log(step_size),
        log_step_avg=torch.log(step_size),
        h_avg=torch.zeros_like(step_size),
        t=torch.zeros_like(step_size),
        mu=torch.log(10.0 * step_size),
    )


def da_update(state, accept_prob, target=0.8, gamma=0.05, t0=10.0,
              kappa=0.75):
    t = state.t + 1.0
    h_avg = (1.0 - 1.0 / (t + t0)) * state.h_avg \
        + (target - accept_prob) / (t + t0)
    log_step = state.mu - torch.sqrt(t) / gamma * h_avg
    eta = t ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, h_avg, t, state.mu)


# -- Welford online (co)variance ---------------------------------------------

class WelfordState(NamedTuple):
    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor     # (dim,) diagonal or (dim, dim) dense


def welford_init(dim, dense=False, dtype=torch.float64, device=None):
    shape = (dim, dim) if dense else (dim,)
    return WelfordState(
        count=torch.zeros((), dtype=dtype, device=device),
        mean=torch.zeros(dim, dtype=dtype, device=device),
        m2=torch.zeros(shape, dtype=dtype, device=device),
    )


def welford_update_batch(state, zs, axis_name=None):
    """Merge a (chains, dim) batch of draws (Chan's parallel update).

    With ``axis_name``, the batch statistics additionally reduce across the
    axis's ranks, so sharded chains contribute to one global estimate.
    """
    n_b = torch.as_tensor(float(zs.shape[0]), dtype=zs.dtype,
                          device=zs.device)
    mean_b = torch.mean(zs, dim=0)
    if axis_name is not None:
        n_b = psum(n_b, axis_name)
        mean_b = pmean(mean_b, axis_name)
    centered = zs - mean_b
    if state.m2.dim() == 2:
        m2_b = centered.T @ centered
    else:
        m2_b = torch.sum(centered * centered, dim=0)
    if axis_name is not None:
        m2_b = psum(m2_b, axis_name)
    n = state.count + n_b
    delta = mean_b - state.mean
    mean = state.mean + delta * n_b / torch.clamp(n, min=1.0)
    cross = torch.outer(delta, delta) if state.m2.dim() == 2 \
        else delta * delta
    m2 = state.m2 + m2_b + cross * state.count * n_b / torch.clamp(n, min=1.0)
    return WelfordState(n, mean, m2)


def welford_merge_across(state, axis_name):
    """Exact merge of per-rank Welford states over a mesh axis.

    Welford merging is associative, so accumulating locally and merging
    only when the variance is *read* (window boundaries) is mathematically
    identical to reducing the batch moments every step, at 1/window_len
    the collectives.  Merged via the sufficient statistics
    (n, sum z, sum zz^T):  m2_g = sum_d (m2_d + n_d mean_d mean_d^T)
    - n_g mean_g mean_g^T.
    """
    n = psum(state.count, axis_name)
    s1 = psum(state.count * state.mean, axis_name)
    mean = s1 / torch.clamp(n, min=1.0)
    if state.m2.dim() == 2:
        raw = state.m2 + state.count * torch.outer(state.mean, state.mean)
        m2 = psum(raw, axis_name) - n * torch.outer(mean, mean)
    else:
        raw = state.m2 + state.count * state.mean ** 2
        m2 = psum(raw, axis_name) - n * mean ** 2
    return WelfordState(n, mean, m2)


def welford_variance(state, regularize=True):
    """The (regularized, as in Stan) variance / covariance estimate."""
    n = torch.clamp(state.count, min=2.0)
    var = state.m2 / (n - 1.0)
    if regularize:
        shrink = n / (n + 5.0)
        var = shrink * var
        if var.dim() == 2:
            var = var + 1e-3 * (1.0 - shrink) * torch.eye(
                var.shape[0], dtype=var.dtype, device=var.device)
        else:
            var = var + 1e-3 * (1.0 - shrink)
    return var


# -- the warmup window schedule ------------------------------------------------

def build_schedule(num_warmup, init_buffer=75, term_buffer=50, base_window=25):
    """Per-step flags: (update_mass_window, window_end), Stan's scheme."""
    if num_warmup < 20:
        in_window = np.zeros(num_warmup, bool)
        window_end = np.zeros(num_warmup, bool)
        return in_window, window_end
    if init_buffer + term_buffer + base_window > num_warmup:
        scale = num_warmup / (init_buffer + term_buffer + base_window)
        init_buffer = int(init_buffer * scale)
        term_buffer = int(term_buffer * scale)
        base_window = num_warmup - init_buffer - term_buffer

    in_window = np.zeros(num_warmup, bool)
    window_end = np.zeros(num_warmup, bool)
    t = init_buffer
    w = base_window
    while t < num_warmup - term_buffer:
        end = min(t + w, num_warmup - term_buffer)
        # The final window absorbs any remainder that couldn't double again.
        if end + 2 * w > num_warmup - term_buffer:
            end = num_warmup - term_buffer
        in_window[t:end] = True
        window_end[end - 1] = True
        t = end
        w *= 2
    return in_window, window_end


# -- step size initialization ---------------------------------------------------

def find_reasonable_step_size(batched_vg, state, inv_mass, generator,
                              step_size=1.0, target=0.5, max_iter=64):
    """Double/halve the step until one chain's one-step accept probability
    crosses ``target``.

    :param state: one chain's :class:`HMCState` (z (dim,), scalar logp,
        grad (dim,)); each probe is one call of ``batched_vg`` on a batch
        of that one chain.
    """
    r0 = sample_momentum(generator, inv_mass, state.z.shape, state.z.dtype)
    energy0 = -state.logp + kinetic_energy(r0, inv_mass)

    def accept_logprob(eps):
        r_half = r0 + 0.5 * eps * state.grad
        z1 = state.z + eps * velocity(r_half, inv_mass)
        logp1, grad1 = batched_vg(z1[None])
        r1 = r_half + 0.5 * eps * grad1[0]
        delta = float(energy0 - (-logp1[0] + kinetic_energy(r1, inv_mass)))
        return -math.inf if math.isnan(delta) else delta

    log_target = math.log(target)
    eps = float(step_size)
    a = accept_logprob(eps)
    going_up = a > log_target
    i = 0
    # The loop's first test re-reads the probe at the initial step.
    while i < max_iter and (a > log_target if going_up else a < log_target):
        eps *= 2.0 if going_up else 0.5
        i += 1
        a = accept_logprob(eps)
    # One step back on the way up so the accept prob ends >= target.
    return eps * 0.5 if going_up else eps


def find_reasonable_step_size_batched(batched_vg, states, inv_mass,
                                      generator, step_size=1.0, target=0.5,
                                      max_iter=64, axis_name=None):
    """Double/halve the step until the batch-mean one-step accept
    probability crosses ``target``.

    Every chain is probed with one leapfrog per iteration (one batched
    value+gradient call), and the decision statistic pools the whole batch
    (and the axis's ranks when ``axis_name`` is given, so every rank takes
    the same decisions and returns the same step).
    """
    r0 = sample_momentum(generator, inv_mass, states.z.shape, states.z.dtype)
    energy0 = -states.logp + kinetic_energy(r0, inv_mass)

    def mean_accept_logprob(eps):
        r_half = r0 + 0.5 * eps * states.grad
        z1 = states.z + eps * velocity(r_half, inv_mass)
        logp1, grad1 = batched_vg(z1)
        r1 = r_half + 0.5 * eps * grad1
        delta = energy0 - (-logp1 + kinetic_energy(r1, inv_mass))
        accept = torch.where(torch.isnan(delta), torch.zeros_like(delta),
                             torch.exp(torch.clamp(delta, max=0.0)))
        a = torch.mean(accept)
        if axis_name is not None:
            a = pmean(a, axis_name)
        # log(0) = -inf when every probe is rejected, as in the reference.
        return float(torch.log(a))

    log_target = math.log(target)
    eps = float(step_size)
    a = mean_accept_logprob(eps)
    going_up = a > log_target
    i = 0
    # The loop's first test re-reads the probe at the initial step.
    while i < max_iter and (a > log_target if going_up else a < log_target):
        eps *= 2.0 if going_up else 0.5
        i += 1
        a = mean_accept_logprob(eps)
    # One step back on the way up so the accept prob ends >= target.
    return eps * 0.5 if going_up else eps
