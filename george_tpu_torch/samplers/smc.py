# -*- coding: utf-8 -*-
"""Adaptive-tempering Sequential Monte Carlo.

For multimodal posteriors (the quasi-periodic ExpSine2 period posterior)
where HMC / NUTS mix poorly between modes.  The particle cloud anneals from
an initial distribution to the target through ESS-adaptive temperature
steps, with systematic resampling and random-walk Metropolis or Metropolis
HMC mutations whose proposal scale tracks the cloud.

The particles are the batch axis: every evaluation of the target is one
call of the density's batched value+gradient (on the card, one launch of
a fused kernel) where it has one, and everything else stays on the device
but one host sync a stage (the loop's condition).  Random numbers come
from a *stream* (:class:`GeneratorStream`, or any object with its
``stage_draws``), drawn a stage at a time.

With ``axis_name`` (a mesh axis) the cloud stays replicated on every rank
and the density evaluations shard: each rank evaluates its slice of the
particles and the results are gathered back, so temperatures, resampling
and the random stream are those of the run on one device.
"""

from typing import NamedTuple

import math

import torch

from .._device import resolve_device
from ..parallel.collectives import all_gather, pmax, pmean
from ..parallel.mesh import shard
from .mcmc import _autograd_vg, _CountedVG

__all__ = ["run_smc", "SMCResult", "GeneratorStream"]


class SMCResult(NamedTuple):
    particles: torch.Tensor      # (num_particles, dim) final cloud
    log_prob: torch.Tensor       # (num_particles,) target density there
    log_evidence: torch.Tensor   # log normalizing-constant estimate
    num_stages: int              # temperature steps taken
    acceptance: torch.Tensor     # mean MH acceptance of the final stage
    lambdas: torch.Tensor = None  # (num_stages,) the temperature schedule
    num_evaluations: int = 0     # the target's batched evaluations


class GeneratorStream(object):
    """A stage's random numbers from one ``torch.Generator``: the
    resampling uniform, then each mutation's standard normals (n, dim) and
    accept uniforms (n,)."""

    def __init__(self, generator):
        self.generator = generator

    def stage_draws(self, n, dim, num_mutations, dtype, device):
        g = self.generator
        u = torch.rand((), generator=g, dtype=dtype, device=device)
        eps = torch.randn((num_mutations, n, dim), generator=g, dtype=dtype,
                          device=device)
        acc = torch.rand((num_mutations, n), generator=g, dtype=dtype,
                         device=device)
        return u, eps, acc


def _systematic_resample(u, log_weights):
    """Systematic resampling at the uniform draw ``u``; returns parent
    indices."""
    n = log_weights.shape[0]
    w = torch.exp(log_weights - torch.logsumexp(log_weights, 0))
    cum = torch.cumsum(w, 0)
    pos = (u + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    return torch.searchsorted(cum, pos, right=False).clamp(0, n - 1)


def _ess(log_w):
    log_norm = torch.logsumexp(log_w, 0)
    return torch.exp(2.0 * log_norm - torch.logsumexp(2.0 * log_w, 0))


def _stream(key, device):
    if hasattr(key, "stage_draws"):
        return key
    if isinstance(key, torch.Generator):
        return GeneratorStream(key)
    g = torch.Generator(device=device)
    g.manual_seed(int(key))
    return GeneratorStream(g)


def run_smc(log_prob, log_init_prob, particles0, key, num_mutations=5,
            target_ess_frac=0.5, max_stages=100, rw_scale=0.5,
            mutation="rw", num_leapfrog=8, hmc_step_scale=0.6,
            axis_name=None, device=None):
    """Anneal particles from ``exp(log_init_prob)`` to ``exp(log_prob)``.

    :param log_prob: the batched target log density, ``(n, dim) -> (n,)``;
        its ``batched_value_and_grad`` (as ``build_gp_log_prob`` attaches)
        gives every value and gradient where it has one, autograd
        otherwise.
    :param log_init_prob: the batched log density the particles were drawn
        from (tempering path: (1 - lam) * init + lam * target).
    :param particles0: (num_particles, dim) draws from the init density.
    :param key: an int seed, a ``torch.Generator`` on ``device``, or a
        stream with :meth:`GeneratorStream.stage_draws`.
    :param num_mutations: MH / HMC steps per temperature stage.
    :param target_ess_frac: ESS fraction that picks each temperature jump
        (bisection).
    :param mutation: ``"rw"`` -- random-walk MH with cloud-covariance
        proposals (gradient-free); ``"hmc"`` -- Metropolis HMC with
        ``num_leapfrog`` leapfrogs a mutation and the cloud covariance as
        the inverse mass matrix (so the dimensionless ``hmc_step_scale``
        transfers across problems).
    :param axis_name: a mesh axis (:class:`george_tpu_torch.parallel.mesh.
        Axis`) over whose ranks the evaluations shard (each rank evaluates
        its contiguous slice of the particles; their number must divide
        over the axis); every rank then returns the same result, and
        ``num_evaluations`` counts this rank's calls.
    :param device: where the run happens (default: the CUDA card).
    """
    if mutation not in ("rw", "hmc"):
        raise ValueError("unknown mutation '{0}'".format(mutation))
    device = resolve_device(device)
    thetas = torch.as_tensor(particles0, device=device)
    n, dim = thetas.shape
    dtype = thetas.dtype
    stream = _stream(key, device)

    if axis_name is not None and n % axis_name.size:
        raise ValueError("num_particles must divide the particle axis")

    def distributed(vf):
        """``vf`` on this rank's slice of the particles, its outputs
        gathered back in one collective (the identity without an axis)."""
        if axis_name is None:
            return vf

        def sharded(z, *rest):
            out = vf(shard(z, axis_name), *rest)
            cols = [a.reshape(a.shape[0], -1) for a in out]
            full = all_gather(torch.cat(cols, dim=1), axis_name)
            parts = torch.split(full, [c.shape[1] for c in cols], dim=1)
            return tuple(p.reshape((full.shape[0],) + a.shape[1:])
                         for p, a in zip(parts, out))

        return sharded

    fused = getattr(log_prob, "batched_value_and_grad", None)
    counted = _CountedVG(fused or _autograd_vg(log_prob))
    init_vg = getattr(log_init_prob, "batched_value_and_grad", None) \
        or _autograd_vg(log_init_prob)
    neg_inf = torch.tensor(-math.inf, dtype=dtype, device=device)

    def target_value(z):
        if fused is not None:
            return counted(z)[0]
        counted.calls += 1
        return log_prob(z)

    @distributed
    def densities(z):
        return target_value(z), log_init_prob(z)

    def components(z):
        """(log target, log init) with NaNs mapped to -inf (rejection)."""
        lt, li = densities(z)
        return (torch.where(torch.isnan(lt), neg_inf, lt),
                torch.where(torch.isnan(li), neg_inf, li))

    @distributed
    def tempered_vg(z, lam):
        lt, gt = counted(z)
        li, gi = init_vg(z)
        return (lam * lt + (1.0 - lam) * li, lt, li,
                lam * gt + (1.0 - lam) * gi)

    def choose_lambda(lam, delta_logw):
        """Largest new lambda in (lam, 1] keeping ESS >= target: bisection,
        at most 30 halvings or until the bracket is 1e-6 wide, in masked
        lockstep on the device."""
        target = target_ess_frac * n

        def ess_at(new_lam):
            return _ess((new_lam - lam) * delta_logw)

        one = torch.ones((), dtype=dtype, device=device)
        full = ess_at(one) >= target
        lo, hi = lam, one
        for _ in range(30):
            active = hi - lo > 1e-6
            mid = 0.5 * (lo + hi)
            ok = ess_at(mid) >= target
            lo, hi = (torch.where(active & ok, mid, lo),
                      torch.where(active & ~ok, mid, hi))
        return torch.where(full, one, lo)

    accept_target = 0.65 if mutation == "hmc" else 0.234
    log_lo, log_hi = math.log(1e-3), math.log(30.0)

    def run_mutations(thetas, lt, li, lam, log_scale, extra, eps_all, u_all,
                      step_fn):
        """Propose -> MH accept -> adapt the scale, ``num_mutations``
        times.  The reported acceptance is the expected one,
        E[min(1, e^delta)], the statistic the adaptation tracks."""
        accepts = torch.zeros((), dtype=dtype, device=device)
        for t in range(num_mutations):
            prop, lt1, li1, extra1, delta = step_fn(
                eps_all[t], thetas, lt, li, extra, lam, torch.exp(log_scale))
            delta = torch.where(torch.isnan(delta), neg_inf, delta)
            take = torch.log(u_all[t]) < delta
            thetas = torch.where(take[:, None], prop, thetas)
            lt = torch.where(take, lt1, lt)
            li = torch.where(take, li1, li)
            if extra is not None:
                extra = torch.where(take[:, None], extra1, extra)
            acc = torch.mean(torch.clamp(torch.exp(delta), max=1.0))
            log_scale = torch.clamp(log_scale + 1.0 * (acc - accept_target),
                                    log_lo, log_hi)
            accepts = accepts + acc
        return thetas, lt, li, accepts / num_mutations, log_scale

    def cloud_cov(thetas):
        centered = thetas - torch.mean(thetas, dim=0)
        cov = centered.T @ centered / n
        return cov + 1e-10 * torch.eye(dim, dtype=dtype, device=device)

    def mutate(thetas, lt, li, lam, log_scale, eps_all, u_all):
        """Random-walk MH at temperature lam, cloud-covariance proposals;
        the carried densities mean one target evaluation a step."""
        chol = torch.linalg.cholesky(cloud_cov(thetas)) * rw_scale

        def step_fn(eps, thetas, lt, li, extra, lam, scale):
            prop = thetas + scale * (eps @ chol.T)
            lt1, li1 = components(prop)
            delta = lam * (lt1 - lt) + (1.0 - lam) * (li1 - li)
            return prop, lt1, li1, extra, delta

        return run_mutations(thetas, lt, li, lam, log_scale, None, eps_all,
                             u_all, step_fn)

    def mutate_hmc(thetas, lt, li, lam, log_scale, eps_all, u_all):
        """Metropolis-HMC at temperature lam with M^-1 = the cloud
        covariance; gradients carry across steps (accept-selected), so a
        mutation costs ``num_leapfrog`` batched evaluations (plus one a
        stage to seed the carry)."""
        inv_mass = cloud_cov(thetas)
        eps_base = hmc_step_scale / (1.0 * dim) ** 0.25
        chol_im = torch.linalg.cholesky(inv_mass)

        def velocity(r):
            return r @ inv_mass.T

        def kinetic(r):
            return 0.5 * torch.sum(velocity(r) * r, dim=-1)

        def step_fn(eps_n, thetas, lt, li, grad, lam, scale):
            eps = eps_base * scale
            # r ~ N(0, M):  r = L^-T eps with L = chol(M^-1).
            r = torch.linalg.solve_triangular(chol_im.T, eps_n.T,
                                              upper=True).T
            energy0 = -(lam * lt + (1.0 - lam) * li) + kinetic(r)
            z, val, lt_c, li_c, g = thetas, None, lt, li, grad
            for _ in range(num_leapfrog):
                r_half = r + 0.5 * eps * g
                z = z + eps * velocity(r_half)
                val, lt_c, li_c, g = tempered_vg(z, lam)
                r = r_half + 0.5 * eps * g
            energy1 = -val + kinetic(r)
            return z, lt_c, li_c, g, energy0 - energy1

        grad0 = tempered_vg(thetas, lam)[3]
        return run_mutations(thetas, lt, li, lam, log_scale, grad0, eps_all,
                             u_all, step_fn)

    do_mutate = mutate_hmc if mutation == "hmc" else mutate
    log_n = math.log(1.0 * n)
    with torch.no_grad():
        lt, li = components(thetas)
        lam = torch.zeros((), dtype=dtype, device=device)
        logz = torch.zeros((), dtype=dtype, device=device)
        accept = torch.zeros((), dtype=dtype, device=device)
        log_scale = torch.zeros((), dtype=dtype, device=device)
        lambdas = []
        stage = 0
        while stage < max_stages and float(lam) < 1.0:  # one sync a stage
            u_rs, eps_all, u_all = stream.stage_draws(n, dim, num_mutations,
                                                      dtype, device)
            # The carried densities make the incremental weights free.
            delta_logw = torch.where(torch.isinf(li) & (li < 0), neg_inf,
                                     lt - li)
            new_lam = choose_lambda(lam, delta_logw)
            log_w = (new_lam - lam) * delta_logw
            logz = logz + torch.logsumexp(log_w, 0) - log_n
            parents = _systematic_resample(u_rs, log_w)
            thetas, lt, li = thetas[parents], lt[parents], li[parents]
            thetas, lt, li, accept, log_scale = do_mutate(
                thetas, lt, li, new_lam, log_scale, eps_all, u_all)
            lam = new_lam
            lambdas.append(lam)
            stage += 1
    if axis_name is not None:
        # Every rank holds the same result (the same stream, the same
        # gathered evaluations); the pooling reduces it over the axis as
        # the JAX package's does.
        thetas, lt, logz, accept = (pmean(v, axis_name)
                                    for v in (thetas, lt, logz, accept))
        stage = int(pmax(torch.tensor(stage, device=device), axis_name))
    return SMCResult(
        particles=thetas, log_prob=lt, log_evidence=logz, num_stages=stage,
        acceptance=accept,
        lambdas=torch.stack(lambdas) if lambdas else lam.new_zeros(0),
        num_evaluations=counted.calls)
