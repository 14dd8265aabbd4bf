# -*- coding: utf-8 -*-
"""ChEES-HMC: gradient-based trajectory-length adaptation (batch kernel).

ChEES-HMC (Hoffman, Radul & Sountsov, AISTATS 2021) runs ONE shared
trajectory length for the whole chain batch, jittered by a shared
quasi-random factor each iteration and adapted during warmup by stochastic
gradient ascent on the Change-in-the-Estimator-of-the-Expected-Square
criterion

    ChEES = 1/4 E[ (||z' - E z'||^2 - ||z - E z||^2)^2 ].

Every chain takes the same number of leapfrog steps per iteration, so the
whole batch advances through one batched value+gradient call per leapfrog
(the fused Kalman kernel on the state-space path).  With an ``axis_name``
(a mesh axis) the cross-chain means pool over its ranks too.
"""

from typing import NamedTuple

import math

import torch

from ..parallel.collectives import pmean
from .hmc import HMCState, kinetic_energy, sample_momentum, velocity

__all__ = [
    "TrajectoryState", "traj_init", "traj_update",
    "chees_step", "halton_sequence", "ChEESInfo",
]


def halton_sequence(i):
    """Van der Corput base-2 radical inverse of integer(s) ``i`` in [0, 1).

    The shared per-iteration trajectory jitter; quasi-random so the warmup's
    gradient estimates stratify [0, 1) instead of clumping.  Returns a
    float32 tensor (like the reference).
    """
    i = torch.as_tensor(i, dtype=torch.int64) & 0xFFFFFFFF
    i = ((i & 0x55555555) << 1) | ((i & 0xAAAAAAAA) >> 1)
    i = ((i & 0x33333333) << 2) | ((i & 0xCCCCCCCC) >> 2)
    i = ((i & 0x0F0F0F0F) << 4) | ((i & 0xF0F0F0F0) >> 4)
    i = ((i & 0x00FF00FF) << 8) | ((i & 0xFF00FF00) >> 8)
    i = ((i << 16) | (i >> 16)) & 0xFFFFFFFF
    return i.to(torch.float32) / 4294967296.0


# -- trajectory-length adaptation state (Adam on log T) ------------------------

class TrajectoryState(NamedTuple):
    log_t: torch.Tensor      # log of the max trajectory *time*
    m: torch.Tensor          # Adam first moment
    v: torch.Tensor          # Adam second moment
    count: torch.Tensor
    log_t_avg: torch.Tensor  # iterate average (used after warmup)


def traj_init(t0):
    t0 = torch.as_tensor(t0)
    z = torch.zeros_like(t0)
    return TrajectoryState(torch.log(t0), z, z, z, torch.log(t0))


def traj_update(state, grad_log_t, step_size, max_leapfrog,
                learning_rate=0.025, b1=0.0, b2=0.5, averaging_frac=0.5):
    """Adam ascent step on log T, clipped to [step, max_leapfrog * step].

    b1=0, b2=0.5 follow the paper's reference implementation (fast tracking
    of the noisy criterion gradient); the returned average is an exponential
    iterate average warmed over ``averaging_frac``.
    """
    g = -grad_log_t  # Adam minimizes; we ascend the criterion
    count = state.count + 1.0
    m = b1 * state.m + (1.0 - b1) * g
    v = b2 * state.v + (1.0 - b2) * g * g
    mhat = m / (1.0 - b1 ** count) if b1 > 0 else m
    vhat = v / (1.0 - b2 ** count)
    log_t = state.log_t - learning_rate * mhat / (torch.sqrt(vhat) + 1e-8)
    lo = torch.log(torch.as_tensor(step_size))
    hi = torch.log(max_leapfrog * torch.as_tensor(step_size))
    log_t = torch.minimum(torch.maximum(log_t, lo), hi)
    # Polyak-style tail averaging, weight ~ t^{-averaging_frac}.
    eta = count ** (-averaging_frac)
    log_t_avg = eta * log_t + (1.0 - eta) * state.log_t_avg
    log_t_avg = torch.minimum(torch.maximum(log_t_avg, lo), hi)
    return TrajectoryState(log_t, m, v, count, log_t_avg)


# -- the batch transition -------------------------------------------------------

class ChEESInfo(NamedTuple):
    accept_prob: torch.Tensor    # (chains,)
    accepted: torch.Tensor       # (chains,) bool
    diverging: torch.Tensor      # (chains,) bool
    energy: torch.Tensor         # (chains,)
    n_leapfrog: int              # shared by construction
    grad_log_t: torch.Tensor     # scalar ChEES gradient estimate d/d log T


def _cross_mean(x, axis_name, dim=0):
    m = torch.mean(x, dim=dim)
    if axis_name is not None:
        m = pmean(m, axis_name)
    return m


def chees_step(generator, states, batched_vg, step_size, inv_mass, traj_time,
               max_leapfrog=1024, axis_name=None,
               divergence_threshold=1000.0):
    """One jittered-HMC transition for the WHOLE chain batch.

    :param states: batched :class:`HMCState` (leading chains axis).
    :param batched_vg: ``f(zs (B, dim)) -> (logps (B,), grads (B, dim))``.
    :param step_size, traj_time: 0-d tensors; steps = ceil(t / eps), shared
        by all chains, capped at ``max_leapfrog`` (read once per call).
    :param axis_name: a mesh axis over whose ranks the ChEES statistics
        pool (chains sharded over it), or None.
    :returns: (new_states, :class:`ChEESInfo`).
    """
    num_chains, dim = states.z.shape
    dtype = states.z.dtype
    n_steps = int(min(max(math.ceil(float(traj_time / step_size)), 1),
                      max_leapfrog))

    r0 = sample_momentum(generator, inv_mass, (num_chains, dim), dtype)
    energy0 = -states.logp + kinetic_energy(r0, inv_mass)

    z1, logp1, grad1, r1 = states.z, states.logp, states.grad, r0
    for _ in range(n_steps):
        r_half = r1 + 0.5 * step_size * grad1
        z1 = z1 + step_size * velocity(r_half, inv_mass)
        logp1, grad1 = batched_vg(z1)
        r1 = r_half + 0.5 * step_size * grad1

    energy1 = -logp1 + kinetic_energy(r1, inv_mass)
    delta = energy0 - energy1
    delta = torch.where(torch.isnan(delta),
                        torch.full_like(delta, -math.inf), delta)
    accept_prob = torch.clamp(torch.exp(delta), max=1.0)
    diverging = -delta > divergence_threshold

    u = torch.rand(num_chains, generator=generator, dtype=dtype,
                   device=states.z.device)
    accept = u < accept_prob
    new = HMCState(
        z=torch.where(accept[:, None], z1, states.z),
        logp=torch.where(accept, logp1, states.logp),
        grad=torch.where(accept[:, None], grad1, states.grad),
    )

    # ChEES criterion gradient w.r.t. log T (paper eq. 8):
    #   per chain  a = ||z' - m'||^2 - ||z - m||^2,   d a / d t = 2 (z'-m')·v'
    #   d/d t  1/4 E[a^2] = E[ a (z'-m')·v' ],  weighted by accept prob;
    #   d/d log T = t * d/d t.
    # The proposal-side statistics are accept-weighted AND finite-masked:
    # one exploded endpoint would otherwise drag the cross-chain mean.
    finite1 = torch.all(torch.isfinite(z1), dim=-1) \
        & torch.all(torch.isfinite(r1), dim=-1)
    w = torch.where(diverging | ~finite1, torch.zeros_like(accept_prob),
                    accept_prob)
    z1_safe = torch.where(finite1[:, None], z1, torch.zeros_like(z1))
    r1_safe = torch.where(finite1[:, None], r1, torch.zeros_like(r1))
    w_mean = torch.mean(w)
    m0 = torch.mean(states.z, dim=0)
    m1 = torch.mean(w[:, None] * z1_safe, dim=0)
    if axis_name is not None:
        # The three cross-chain means in one reduction over the axis.
        means = pmean(torch.cat([w_mean[None], m0, m1]), axis_name)
        w_mean, m0, m1 = means[0], means[1:dim + 1], means[dim + 1:]
    denom = torch.clamp(w_mean, min=1e-10)
    m1 = m1 / denom
    v1 = velocity(r1_safe, inv_mass)
    a = torch.sum((z1_safe - m1) ** 2, dim=-1) - torch.sum(
        (states.z - m0) ** 2, dim=-1
    )
    dot = torch.sum((z1_safe - m1) * v1, dim=-1)
    grad_t = _cross_mean(w * a * dot, axis_name) / denom
    grad_log_t = grad_t * traj_time
    # All-divergent batches give no signal: freeze instead of NaN.
    grad_log_t = torch.where(
        torch.isfinite(grad_log_t) & (w_mean > 1e-10), grad_log_t,
        torch.zeros_like(grad_log_t),
    )

    info = ChEESInfo(accept_prob, accept, diverging, energy1, n_steps,
                     grad_log_t)
    return new, info
