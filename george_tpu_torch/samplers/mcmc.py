# -*- coding: utf-8 -*-
"""Batch MCMC driver: warmup adaptation + sampling for NUTS, HMC and
ChEES-HMC.

Chains are the leading dimension of every tensor.  Adaptation statistics
(mean accept probability, Welford moments) pool across the chain batch.
The run is host-orchestrated: a Python loop over transitions, each one a
few batched tensor operations plus one batched value+gradient call per
leapfrog, split into blocks between which a ``progress`` callback runs.
Trajectory-persistent NUTS runs its draws in blocks of
:func:`nuts.nuts_draws_persistent` loops, its stream carried across blocks.

:func:`make_mcmc_core` builds the run; :func:`run_mcmc` runs it on one
device, :func:`george_tpu_torch.parallel.run_mcmc_sharded` on every rank of
a chain axis, whose ranks then pool the adaptation: the dual-averaging
state every ``sync_every`` steps and at window ends, the Welford moments
when the mass matrix is read, ChEES's statistics every step.
"""

from typing import NamedTuple

import torch

from .._device import resolve_device
from ..parallel.collectives import pmean
from . import adaptation as adapt
from . import chees
from .hmc import HMCState, hmc_step
from .nuts import nuts_draws_persistent, nuts_step

__all__ = ["run_mcmc", "make_mcmc_core", "MCMCResult"]


class MCMCResult(NamedTuple):
    samples: torch.Tensor        # (chains, num_samples, dim)
    log_prob: torch.Tensor       # (chains, num_samples)
    accept_prob: torch.Tensor    # (chains, num_samples)
    diverging: torch.Tensor      # (chains, num_samples) bool
    n_leapfrog: torch.Tensor     # (chains, num_samples)
    step_size: torch.Tensor      # scalar (adapted)
    inv_mass: torch.Tensor       # (dim,) or (dim, dim)
    warmup_accept_prob: torch.Tensor  # (num_warmup,) batch-mean accept prob
    num_evaluations: int         # batched value+gradient calls of the run


class _Pieces(NamedTuple):
    """Building blocks of one algorithm, driven by :func:`_run_blocked`."""

    chain_init: object      # z0 -> states
    init_step_size: object  # (states, inv_mass, generator) -> float
    warm_step: object       # (carry, in_win, win_end, idx, gen) ->
    #                         (carry, batch-mean accept prob)
    draw_step: object       # (states, gen, eps, inv_mass, extra) ->
    #                         (states, info)
    schedule: tuple         # (in_window, window_end) numpy arrays
    extra_init: object      # eps0 -> algorithm-specific warmup state
    # Optional block sampler: (states, gen, n, eps, inv_mass, extra) ->
    # (states, outs) with outs (z, logp, accept_prob, diverging,
    # n_leapfrog) already (chains, n, ...): trajectory-persistent NUTS,
    # whose n-draw loop runs one leapfrog an iteration across transitions.
    draw_many: object = None


class _CountedVG(object):
    """A batched value+gradient that counts its calls."""

    def __init__(self, vg):
        self.vg = vg
        self.calls = 0

    def __call__(self, z):
        self.calls += 1
        return self.vg(z)


def _autograd_vg(log_prob):
    """``vmap(value_and_grad(log_prob))`` for a batched, differentiable
    ``log_prob((B, dim)) -> (B,)``."""

    def vg(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            lp = log_prob(z)
            g, = torch.autograd.grad(lp.sum(), z)
        return lp.detach(), g

    return vg


def _pmean_tree(tree, axis_name):
    """The mean over the axis of every tensor of a NamedTuple, in one
    collective."""
    leaves = [torch.as_tensor(v) for v in tree]
    flat = torch.cat([v.reshape(-1) for v in leaves])
    flat = pmean(flat, axis_name)
    out, at = [], 0
    for v in leaves:
        out.append(flat[at:at + v.numel()].reshape(v.shape))
        at += v.numel()
    return type(tree)(*out)


def _sync_da(da, sync, axis_name):
    """Pool the dual-averaging state across the axis's ranks at sync points.

    Every DA field is affine in the per-step accept statistics with
    rank-identical coefficients, so pooling the *state* at any cadence
    lands on exactly the trajectory that pooling the accept statistic every
    step produces at those points; between syncs each rank runs on its
    local accept mean.  ``sync_every=1`` therefore reproduces the pooled
    stream step for step.
    """
    if axis_name is None or not sync:
        return da
    return _pmean_tree(da, axis_name)


def _mass_window_update(da, welford, inv_mass, states, in_win, win_end,
                        dim, dense_mass, axis_name=None):
    """Stan's windowed Welford mass adaptation + per-window DA reset.

    Pooling across ranks happens only when the variance is read (window
    ends): Welford accumulates rank-locally and the exact merge
    (:func:`adaptation.welford_merge_across`) runs at the window end, the
    same estimate as reducing the moments every step.
    """
    if in_win:
        welford = adapt.welford_update_batch(welford, states.z)
    if win_end:
        if axis_name is not None:
            welford = adapt.welford_merge_across(welford, axis_name)
        inv_mass = adapt.welford_variance(welford)
        z = states.z
        welford = adapt.welford_init(dim, dense=dense_mass, dtype=z.dtype,
                                     device=z.device)
        # Re-center the step size search at each window boundary.
        da = adapt.da_init(torch.exp(da.log_step))
    return da, welford, inv_mass


def _sync_point(idx, win_end, num_warmup, sync_every):
    """Pool the DA state periodically, and always at window ends and on
    the last warmup step (so the sampling step size is rank-identical)."""
    return (idx + 1) % sync_every == 0 or win_end or idx == num_warmup - 1


def _build_pieces(vg, algorithm, dim, target_accept, max_depth,
                  num_leapfrog, dense_mass, adapt_mass, num_warmup,
                  persistent, axis_name=None, sync_every=8):
    """The building blocks of ``algorithm``: ChEES's from
    :func:`_build_chees_pieces`; NUTS or fixed-length HMC here, per-chain
    trajectories with every leapfrog one batched value+gradient call for
    all chains."""
    if algorithm == "chees":
        return _build_chees_pieces(vg, dim, target_accept, num_leapfrog,
                                   dense_mass, adapt_mass, num_warmup,
                                   axis_name, sync_every)
    if algorithm == "nuts":
        def kernel(states, generator, eps, inv_mass):
            return nuts_step(generator, states, vg, eps, inv_mass,
                             max_depth=max_depth)
    elif algorithm == "hmc":
        def kernel(states, generator, eps, inv_mass):
            return hmc_step(generator, states, vg, eps, inv_mass,
                            n_steps=num_leapfrog)
    else:
        raise ValueError("unknown algorithm '{0}'".format(algorithm))

    def chain_init(z):
        logp, grad = vg(z)
        return HMCState(z, logp, grad)

    def init_step_size(states, inv_mass, generator):
        return adapt.find_reasonable_step_size_batched(
            vg, states, inv_mass, generator, axis_name=axis_name
        )

    def warm_step(carry, in_win, win_end, idx, generator):
        states, da, welford, inv_mass, extra = carry
        states, info = kernel(states, generator, torch.exp(da.log_step),
                              inv_mass)
        accept = torch.mean(info.accept_prob)
        da = adapt.da_update(da, accept, target=target_accept)
        da = _sync_da(da, _sync_point(idx, win_end, num_warmup, sync_every),
                      axis_name)
        if adapt_mass:
            da, welford, inv_mass = _mass_window_update(
                da, welford, inv_mass, states, in_win, win_end, dim,
                dense_mass, axis_name,
            )
        return (states, da, welford, inv_mass, extra), accept

    def draw_step(states, generator, eps, inv_mass, extra):
        return kernel(states, generator, eps, inv_mass)

    draw_many = None
    if algorithm == "nuts" and persistent:
        def draw_many(states, generator, n, eps, inv_mass, extra):
            return nuts_draws_persistent(generator, states, vg, eps,
                                         inv_mass, n, max_depth=max_depth)

    return _Pieces(chain_init, init_step_size, warm_step, draw_step,
                   adapt.build_schedule(num_warmup), lambda eps0: (),
                   draw_many=draw_many)


def _build_chees_pieces(vg, dim, target_accept, max_leapfrog, dense_mass,
                        adapt_mass, num_warmup, axis_name=None,
                        sync_every=8):
    """ChEES-HMC: one shared jittered trajectory for the whole batch."""

    def chain_init(z):
        logp, grad = vg(z)
        return HMCState(z, logp, grad)

    def init_step_size(states, inv_mass, generator):
        return adapt.find_reasonable_step_size_batched(
            vg, states, inv_mass, generator, axis_name=axis_name
        )

    def warm_step(carry, in_win, win_end, idx, generator):
        states, da, welford, inv_mass, traj = carry
        eps = torch.exp(da.log_step)
        # Shared quasi-random jitter: all chains run u * T this iteration.
        u = chees.halton_sequence(idx).to(states.z.dtype).to(eps.device)
        t = u * torch.exp(traj.log_t)
        states, info = chees.chees_step(
            generator, states, vg, eps, inv_mass, t,
            max_leapfrog=max_leapfrog, axis_name=axis_name,
        )
        accept = torch.mean(info.accept_prob)
        da = adapt.da_update(da, accept, target=target_accept)
        da = _sync_da(da, _sync_point(idx, win_end, num_warmup, sync_every),
                      axis_name)
        traj = chees.traj_update(
            traj, info.grad_log_t, torch.exp(da.log_step), max_leapfrog
        )
        if adapt_mass:
            da, welford, inv_mass = _mass_window_update(
                da, welford, inv_mass, states, in_win, win_end, dim,
                dense_mass, axis_name,
            )
        return (states, da, welford, inv_mass, traj), accept

    def draw_step(states, generator, eps, inv_mass, traj):
        u = torch.rand((), generator=generator, dtype=states.z.dtype,
                       device=states.z.device)
        t = u * torch.exp(traj.log_t_avg)
        states, info = chees.chees_step(
            generator, states, vg, eps, inv_mass, t,
            max_leapfrog=max_leapfrog, axis_name=axis_name,
        )
        return states, info

    schedule = adapt.build_schedule(num_warmup)
    # Initial trajectory = one step; the Adam ascent grows it quickly.
    return _Pieces(chain_init, init_step_size, warm_step, draw_step,
                   schedule, chees.traj_init)


def _default_target(algorithm, target_accept):
    if target_accept is not None:
        return target_accept
    # 0.651 is optimal for jittered-trajectory HMC (ChEES paper §4);
    # 0.8 is Stan's default for NUTS/HMC.
    return 0.651 if algorithm == "chees" else 0.8


def _run_blocked(pieces, z0, generator, num_warmup, num_samples, block_size,
                 step_size, dense_mass, progress=None,
                 warmup_block_size=None, axis_name=None):
    """Host-orchestrated execution in blocks (progress between blocks)."""
    num_chains, dim = z0.shape
    dtype, device = z0.dtype, z0.device
    in_window, window_end = pieces.schedule
    init_inv_mass = (
        torch.eye(dim, dtype=dtype, device=device) if dense_mass
        else torch.ones(dim, dtype=dtype, device=device)
    )

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    states = pieces.chain_init(z0)
    if step_size is None:
        eps0 = pieces.init_step_size(states, init_inv_mass, generator)
    else:
        eps0 = step_size
    eps0 = torch.as_tensor(eps0, dtype=dtype, device=device)

    da = adapt.da_init(eps0)
    welford = adapt.welford_init(dim, dense=dense_mass, dtype=dtype,
                                 device=device)
    carry = (states, da, welford, init_inv_mass, pieces.extra_init(eps0))
    wblock = warmup_block_size or block_size or max(num_warmup, 1)
    warm_accs = []
    for idx in range(num_warmup):
        carry, accept = pieces.warm_step(carry, bool(in_window[idx]),
                                         bool(window_end[idx]), idx,
                                         generator)
        warm_accs.append(accept)
        stop = idx + 1
        if progress and (stop % wblock == 0 or stop == num_warmup):
            sync()
            progress("warmup", stop, num_warmup)
    states, da, _, inv_mass, extra = carry
    eps = torch.exp(da.log_step_avg) if num_warmup > 0 else eps0
    if axis_name is not None and num_warmup > 0:
        # One final pooling (numerically a no-op: the last warmup step
        # forced a DA sync) makes the sampling step size and any algorithm
        # state rank-identical.
        eps = pmean(eps, axis_name)
        if len(extra):
            extra = _pmean_tree(extra, axis_name)

    block = block_size or max(num_samples, 1)
    chunks = []
    done = 0
    while done < num_samples:
        if pieces.draw_many is not None:
            n = min(block, num_samples - done)
            states, outs = pieces.draw_many(states, generator, n, eps,
                                            inv_mass, extra)
        else:
            n = 1
            states, info = pieces.draw_step(states, generator, eps, inv_mass,
                                            extra)
            nleap = info.n_leapfrog
            if not torch.is_tensor(nleap):
                nleap = torch.full((num_chains,), nleap, dtype=torch.int64,
                                   device=device)
            outs = tuple(v[:, None] for v in (
                states.z, states.logp, info.accept_prob, info.diverging,
                nleap))
        chunks.append(outs)
        done += n
        if progress and (done % block == 0 or done == num_samples):
            sync()
            progress("sampling", done, num_samples)

    def cat(i, shape_tail, dt):
        if not chunks:
            return torch.zeros((num_chains, 0) + shape_tail, dtype=dt,
                               device=device)
        return torch.cat([c[i] for c in chunks], dim=1)

    return MCMCResult(
        samples=cat(0, (dim,), dtype),
        log_prob=cat(1, (), dtype),
        accept_prob=cat(2, (), dtype),
        diverging=cat(3, (), torch.bool),
        n_leapfrog=cat(4, (), torch.int64),
        step_size=eps,
        inv_mass=inv_mass,
        warmup_accept_prob=torch.stack(warm_accs) if warm_accs
        else torch.zeros(0, dtype=dtype, device=device),
        num_evaluations=0,
    )


def make_mcmc_core(log_prob, num_chains, dim, dtype, num_warmup=500,
                   num_samples=500, algorithm="nuts", target_accept=None,
                   max_depth=10, num_leapfrog=32, dense_mass=False,
                   step_size=None, axis_name=None, adapt_mass=True,
                   sync_every=8, persistent=True, block_size=None,
                   progress=None, warmup_block_size=None):
    """Build the run ``core(z0, generator) -> MCMCResult``.

    :func:`run_mcmc` calls it on one device;
    :func:`george_tpu_torch.parallel.run_mcmc_sharded` calls it on every
    rank of a chain axis with this rank's chains and ``axis_name`` that
    axis, so adaptation pools across the ranks (the dual-averaging state
    every ``sync_every`` warmup steps and at window ends, the Welford
    moments at window ends, the step-size probe and ChEES's statistics at
    every call) and the step size, mass matrix and ChEES trajectory are the
    same bits on every rank.  The other arguments are :func:`run_mcmc`'s.
    """
    if algorithm not in ("nuts", "hmc", "chees"):
        raise ValueError("unknown algorithm '{0}'".format(algorithm))
    target = _default_target(algorithm, target_accept)

    def core(z0, generator):
        if tuple(z0.shape) != (num_chains, dim) or z0.dtype != dtype:
            raise ValueError("core built for ({0}, {1}) {2} positions; got "
                             "{3} {4}".format(num_chains, dim, dtype,
                                              tuple(z0.shape), z0.dtype))
        vg = _CountedVG(getattr(log_prob, "batched_value_and_grad", None)
                        or _autograd_vg(log_prob))
        pieces = _build_pieces(
            vg, algorithm, dim, target, max_depth, num_leapfrog, dense_mass,
            adapt_mass, num_warmup, persistent, axis_name, sync_every,
        )
        with torch.no_grad():
            res = _run_blocked(
                pieces, z0, generator, num_warmup, num_samples, block_size,
                step_size, dense_mass, progress=progress,
                warmup_block_size=warmup_block_size, axis_name=axis_name,
            )
        return res._replace(num_evaluations=vg.calls)

    return core


def run_mcmc(log_prob, z0, key, num_warmup=500, num_samples=500,
             algorithm="nuts", target_accept=None, max_depth=10,
             num_leapfrog=32, dense_mass=False, step_size=None,
             adapt_mass=True, block_size=None, progress=None,
             persistent=True, warmup_block_size=None, device=None):
    """Run warmup + sampling for a batch of chains on one device.

    :param log_prob: the posterior density: a batched, differentiable
        ``log_prob(z (chains, dim)) -> (chains,)``; when it carries a
        ``batched_value_and_grad`` (as :func:`build_gp_log_prob` attaches
        on its fused routes) that is used for every gradient.
    :param z0: (chains, dim) initial positions; their dtype is the run's.
    :param key: an int seed or a ``torch.Generator`` on ``device``.
    :param algorithm: ``"nuts"`` (iterative masked tree NUTS, trajectories
        of at most 2^max_depth - 1 leapfrogs), ``"hmc"`` (fixed
        ``num_leapfrog`` trajectories), or ``"chees"`` (ChEES-HMC — shared
        jittered trajectory length adapted by gradient ascent on the ChEES
        criterion, every chain in lockstep; here ``num_leapfrog`` is the
        per-iteration leapfrog *cap* and ``target_accept`` defaults to
        0.651, else 0.8).
    :param persistent: NUTS only (default on) — trajectory-persistent
        sampling: chains start their next transition the moment their
        trajectory terminates instead of idling until the batch's longest
        one.  Warmup always keeps per-transition lockstep (cross-chain
        adaptation pooling).  Set False for the per-draw formulation
        (identical posterior; different random stream).
    :param block_size, warmup_block_size: draws / warmup iterations between
        ``progress(phase, done, total)`` callbacks; persistent NUTS runs
        its draws in loops of ``block_size`` draws.
    :param device: where the run happens (default: the CUDA card; raises
        without one unless ``device="cpu"`` is given).
    :returns: :class:`MCMCResult` with per-chain draws and diagnostics;
        ``n_leapfrog`` is each chain's own count and ``num_evaluations``
        every batched value+gradient call of the run.

    For chains sharded over several ranks use
    :func:`george_tpu_torch.parallel.run_mcmc_sharded`.
    """
    device = resolve_device(device)
    z0 = torch.as_tensor(z0, device=device)
    if z0.dim() != 2:
        raise ValueError("z0 must be (chains, dim)")
    num_chains, dim = z0.shape
    core = make_mcmc_core(
        log_prob, num_chains, dim, z0.dtype, num_warmup=num_warmup,
        num_samples=num_samples, algorithm=algorithm,
        target_accept=target_accept, max_depth=max_depth,
        num_leapfrog=num_leapfrog, dense_mass=dense_mass,
        step_size=step_size, adapt_mass=adapt_mass, persistent=persistent,
        block_size=block_size, progress=progress,
        warmup_block_size=warmup_block_size,
    )
    return core(z0, _generator(key, device))


def _generator(key, device):
    """``key`` (an int seed or a ``torch.Generator`` on ``device``) as a
    generator."""
    if isinstance(key, torch.Generator):
        if torch.device(key.device).type != device.type:
            raise ValueError("generator is on {0}, the run on {1}".format(
                key.device, device))
        return key
    generator = torch.Generator(device=device)
    generator.manual_seed(int(key))
    return generator
