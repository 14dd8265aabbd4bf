# -*- coding: utf-8 -*-
"""Automatic Differentiation Variational Inference (Gaussian families).

Maximizes the reparameterized ELBO with Adam (optax's defaults and update
order, in a few lines on tensors).  A step is one call of the density's
batched value+gradient over the ``num_mc`` draws (on the card, one launch
of a fused kernel where the density has one); the ELBO's gradient follows
from the draws' gradients g_i and standard normals eps_i:

  * mean-field -- ``q = N(mu, diag(sigma^2))`` (``full_rank=False``):
    d/d mu = mean g, d/d log sigma = mean(g * eps) * sigma + 1;
  * full-rank -- ``q = N(mu, L L^T)`` with ``L`` lower triangular
    (log-diagonal): d/d L = mean(g eps^T) on the lower triangle, the
    diagonal through exp.

Random numbers come from a stream with ``normal(shape, dtype, device)``
(:class:`NormalStream`), one (num_mc, dim) draw a step.
"""

from typing import NamedTuple

import math

import torch

from .._device import resolve_device
from .mcmc import _autograd_vg

__all__ = ["run_advi", "ADVIResult", "NormalStream"]


class NormalStream(object):
    """Standard normals from one ``torch.Generator``."""

    def __init__(self, generator):
        self.generator = generator

    def normal(self, shape, dtype, device):
        return torch.randn(shape, generator=self.generator, dtype=dtype,
                           device=device)


def _stream(key, device):
    if hasattr(key, "normal"):
        return key
    if isinstance(key, torch.Generator):
        return NormalStream(key)
    g = torch.Generator(device=device)
    g.manual_seed(int(key))
    return NormalStream(g)


class ADVIResult(NamedTuple):
    mean: torch.Tensor        # (dim,) variational mean
    log_std: torch.Tensor     # (dim,) marginal log stddev of q
    elbo: torch.Tensor        # (num_steps,) ELBO trace
    scale_tril: torch.Tensor = None  # (dim, dim) Cholesky factor (full-rank)

    def sample(self, key, num_samples):
        """Draw from the fitted q (``key``: a seed, generator or stream)."""
        dim = self.mean.shape[0]
        eps = _stream(key, self.mean.device).normal(
            (num_samples, dim), self.mean.dtype, self.mean.device)
        if self.scale_tril is not None:
            return self.mean + eps @ self.scale_tril.T
        return self.mean + eps * torch.exp(self.log_std)


def _build_tril(diag_log, off, dim):
    """Lower-triangular scale from log-diagonal + strict lower entries."""
    L = diag_log.new_zeros((dim, dim))
    if dim > 1:
        i, j = torch.tril_indices(dim, dim, offset=-1)
        L[i, j] = off
    return L + torch.diag(torch.exp(diag_log))


class _Adam(object):
    """optax.adam(learning_rate) with its defaults (b1 0.9, b2 0.999, eps
    1e-8, eps_root 0) and its order of operations."""

    def __init__(self, params, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def step(self, params, grads):
        b1, b2 = self.b1, self.b2
        self.count += 1
        c1 = 1.0 - b1 ** self.count
        c2 = 1.0 - b2 ** self.count
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = (1.0 - b1) * g + b1 * self.mu[k]
            self.nu[k] = (1.0 - b2) * (g * g) + b2 * self.nu[k]
            update = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2)
                                          + self.eps)
            out[k] = p + (-self.lr) * update
        return out


def run_advi(log_prob, theta0, key, num_steps=1000, num_mc=8,
             learning_rate=1e-2, init_log_std=-2.0, full_rank=False,
             device=None):
    """Fit a Gaussian q to ``exp(log_prob)`` by stochastic ELBO ascent.

    :param log_prob: the batched log density ``(B, dim) -> (B,)``; its
        ``batched_value_and_grad`` is used where it has one, autograd
        otherwise.
    :param key: an int seed, a ``torch.Generator`` on ``device``, or a
        stream with :meth:`NormalStream.normal`.
    :param full_rank: fit ``N(mu, L L^T)`` instead of a diagonal Gaussian.
    :param device: where the fit runs (default: the CUDA card).
    :returns: :class:`ADVIResult`; draw posterior samples with
        ``result.sample(key, n)``.
    """
    device = resolve_device(device)
    theta0 = torch.as_tensor(theta0, device=device)
    dim = theta0.shape[0]
    dtype = theta0.dtype
    stream = _stream(key, device)
    vg = getattr(log_prob, "batched_value_and_grad", None) \
        or _autograd_vg(log_prob)
    params = {"mean": theta0.clone(),
              "diag_log": torch.full((dim,), init_log_std, dtype=dtype,
                                     device=device)}
    if full_rank:
        params["off"] = torch.zeros(dim * (dim - 1) // 2, dtype=dtype,
                                    device=device)
        tril = torch.tril_indices(dim, dim, offset=-1, device=device)
    opt = _Adam(params, learning_rate)
    entropy_const = 0.5 * dim * (1.0 + math.log(2.0 * math.pi))
    elbo = []
    with torch.no_grad():
        for _ in range(num_steps):
            eps = stream.normal((num_mc, dim), dtype, device)
            if full_rank:
                L = _build_tril(params["diag_log"], params["off"], dim)
                thetas = params["mean"] + eps @ L.T
            else:
                sd = torch.exp(params["diag_log"])
                thetas = params["mean"] + eps * sd
            logps, g = vg(thetas)
            # Out-of-support draws (-inf) would kill the gradient: clamp
            # them to a large negative value, their gradient to zero.
            finite = torch.isfinite(logps)
            logps = torch.where(finite, logps, torch.full_like(logps, -1e12))
            g = torch.where(finite[:, None], g, torch.zeros_like(g))
            # Gaussian entropy = sum log diag(L) + const for both families.
            entropy = torch.sum(params["diag_log"]) + entropy_const
            elbo.append(torch.mean(logps) + entropy)
            grads = {"mean": -torch.mean(g, dim=0)}
            if full_rank:
                G = g.T @ eps / num_mc
                grads["diag_log"] = -(torch.diagonal(G)
                                      * torch.exp(params["diag_log"]) + 1.0)
                grads["off"] = -G[tril[0], tril[1]]
            else:
                grads["diag_log"] = -(torch.mean(g * eps, dim=0) * sd + 1.0)
            params = opt.step(params, grads)
    elbo = torch.stack(elbo) if elbo else theta0.new_zeros(0)
    if full_rank:
        L = _build_tril(params["diag_log"], params["off"], dim)
        marg_log_std = 0.5 * torch.log(torch.sum(L * L, dim=1))
        return ADVIResult(params["mean"], marg_log_std, elbo, scale_tril=L)
    return ADVIResult(params["mean"], params["diag_log"], elbo)
