# -*- coding: utf-8 -*-
"""Hamiltonian Monte Carlo primitives, batch-first.

Positions, momenta and gradients are (chains, dim) tensors.  Mass matrices
are diagonal (a vector ``inv_mass``) or dense (a matrix), dispatched on
ndim.  Random numbers come from an explicit ``torch.Generator``.
"""

from typing import NamedTuple

import torch

__all__ = ["HMCState", "kinetic_energy", "velocity", "sample_momentum"]


class HMCState(NamedTuple):
    """Position, its log-density, and the cached gradient."""

    z: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor


def kinetic_energy(r, inv_mass):
    """0.5 r^T M^{-1} r over the trailing axis, for diagonal or dense M^{-1}."""
    return 0.5 * torch.sum(r * velocity(r, inv_mass), dim=-1)


def velocity(r, inv_mass):
    """dz/dt = M^{-1} r, for (dim,) or (..., dim) momenta."""
    if inv_mass.dim() == 1:
        return inv_mass * r
    return r @ inv_mass.T


def sample_momentum(generator, inv_mass, shape, dtype):
    """r ~ N(0, M).  For diagonal M^{-1}, std = 1/sqrt(inv_mass); for dense,
    draw through the Cholesky factor of M^{-1}: with R = chol(M^{-1}),
    r = R^{-T} eps has covariance M."""
    eps = torch.randn(shape, generator=generator, dtype=dtype,
                      device=inv_mass.device)
    if inv_mass.dim() == 1:
        return eps / torch.sqrt(inv_mass)
    R = torch.linalg.cholesky(inv_mass)
    cols = eps.T if eps.dim() == 2 else eps[:, None]
    out = torch.linalg.solve_triangular(R.T, cols, upper=True)
    return out.T if eps.dim() == 2 else out[:, 0]
