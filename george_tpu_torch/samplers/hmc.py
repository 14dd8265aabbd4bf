# -*- coding: utf-8 -*-
"""Hamiltonian Monte Carlo primitives: kinetic energy, leapfrog, HMC kernel.

Batch-first: positions, momenta and gradients are (chains, dim) tensors and
every gradient is one call of a batched value+gradient
``f(zs (B, dim)) -> (logps (B,), grads (B, dim))`` for all chains.  Mass
matrices are diagonal (a vector ``inv_mass``) or dense (a matrix),
dispatched on ndim.  Random numbers are arguments or come from an explicit
``torch.Generator``.
"""

from typing import NamedTuple

import math

import torch

__all__ = [
    "HMCState", "new_state", "kinetic_energy", "velocity", "sample_momentum",
    "momentum_map", "leapfrog", "leapfrog_one", "HMCInfo",
    "hmc_step",
]


class HMCState(NamedTuple):
    """Position, its log-density, and the cached gradient."""

    z: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor


def new_state(batched_vg, z):
    logp, grad = batched_vg(z)
    return HMCState(z, logp, grad)


def kinetic_energy(r, inv_mass):
    """0.5 r^T M^{-1} r over the trailing axis, for diagonal or dense M^{-1}."""
    return 0.5 * torch.sum(r * velocity(r, inv_mass), dim=-1)


def velocity(r, inv_mass):
    """dz/dt = M^{-1} r, for (dim,) or (..., dim) momenta."""
    if inv_mass.dim() == 1:
        return inv_mass * r
    return r @ inv_mass.T


def momentum_map(inv_mass):
    """The map from standard normals ``eps`` ((dim,) or (chains, dim)) to
    r ~ N(0, M), its factor computed once.  For diagonal M^{-1}, std =
    1/sqrt(inv_mass); for dense, through the Cholesky factor of M^{-1}: with
    R = chol(M^{-1}), r = R^{-T} eps has covariance M."""
    if inv_mass.dim() == 1:
        sqrt_inv_mass = torch.sqrt(inv_mass)
        return lambda eps: eps / sqrt_inv_mass
    Rt = torch.linalg.cholesky(inv_mass).T

    def to_momentum(eps):
        cols = eps.T if eps.dim() == 2 else eps[:, None]
        out = torch.linalg.solve_triangular(Rt, cols, upper=True)
        return out.T if eps.dim() == 2 else out[:, 0]

    return to_momentum


def sample_momentum(generator, inv_mass, shape, dtype):
    """r ~ N(0, M), drawn from ``generator``; ``shape`` is (dim,) or
    (chains, dim)."""
    eps = torch.randn(shape, generator=generator, dtype=dtype,
                      device=inv_mass.device)
    return momentum_map(inv_mass)(eps)


def leapfrog_one(batched_vg, z, r, grad, step_size, inv_mass):
    """One velocity-Verlet step for every chain (NUTS building block);
    ``step_size`` may be a scalar or a (chains, 1) column of signed steps."""
    r_half = r + 0.5 * step_size * grad
    z_new = z + step_size * velocity(r_half, inv_mass)
    logp_new, grad_new = batched_vg(z_new)
    r_new = r_half + 0.5 * step_size * grad_new
    return z_new, r_new, logp_new, grad_new


def leapfrog(batched_vg, state, r, step_size, inv_mass, n_steps):
    """``n_steps`` velocity-Verlet steps, one batched value+gradient each;
    returns (state', r')."""
    z, logp, grad = state
    for _ in range(int(n_steps)):
        z, r, logp, grad = leapfrog_one(batched_vg, z, r, grad, step_size,
                                        inv_mass)
    return HMCState(z, logp, grad), r


class HMCInfo(NamedTuple):
    accept_prob: torch.Tensor    # (chains,)
    accepted: torch.Tensor       # (chains,) bool
    diverging: torch.Tensor      # (chains,) bool
    energy: torch.Tensor         # (chains,)
    n_leapfrog: int


def hmc_step(generator, state, batched_vg, step_size, inv_mass, n_steps,
             divergence_threshold=1000.0, eps=None, u=None):
    """One Metropolis-corrected HMC transition for every chain.

    The momentum's standard normals ``eps`` (chains, dim) and the accept
    uniforms ``u`` (chains,) are drawn from ``generator`` unless given.
    """
    z = state.z
    if eps is None:
        eps = torch.randn(z.shape, generator=generator, dtype=z.dtype,
                          device=z.device)
    if u is None:
        u = torch.rand(z.shape[:1], generator=generator, dtype=z.dtype,
                       device=z.device)
    r0 = momentum_map(inv_mass)(eps)
    energy0 = -state.logp + kinetic_energy(r0, inv_mass)

    proposal, r1 = leapfrog(batched_vg, state, r0, step_size, inv_mass,
                            n_steps)
    energy1 = -proposal.logp + kinetic_energy(r1, inv_mass)
    delta = energy0 - energy1
    delta = torch.where(torch.isnan(delta),
                        torch.full_like(delta, -math.inf), delta)

    accept_prob = torch.clamp(torch.exp(delta), max=1.0)
    diverging = -delta > divergence_threshold
    accept = u < accept_prob
    new = HMCState(
        z=torch.where(accept[:, None], proposal.z, z),
        logp=torch.where(accept, proposal.logp, state.logp),
        grad=torch.where(accept[:, None], proposal.grad, state.grad),
    )
    return new, HMCInfo(accept_prob, accept, diverging, energy1,
                        int(n_steps))
