# -*- coding: utf-8 -*-
"""Multi-rank sampling and data-sharded GP likelihoods.

Two orthogonal parallel axes:

  * **chain sharding** — MCMC chains / SMC particles shard over a mesh
    axis; adaptation moments and accept statistics reduce across its ranks
    so all chains share one step size and mass matrix;
  * **data sharding** — the O(N^2 d) covariance *build* shards over the N
    axis: each rank builds its column stripe ``K[:, local]`` against the
    gathered inputs (on the card a launch of the covariance kernel,
    ``csrc/stationary_cov.cu``), and the stripes are gathered into K.  With
    the distributed Cholesky (:mod:`.dist_chol`) the O(N^3) factorization
    runs sharded as well, so K never exists whole on one rank.

They compose: :func:`run_mcmc_sharded` over a ("chains", "data") mesh
runs chain-parallel samplers whose every log-prob evaluation is itself
data-parallel.

Every function here runs on every rank of the mesh and takes the *global*
arrays; each rank takes its own shard by its index on the axis, and the
results are global on every rank (per-chain outputs gathered, pooled ones
the same bits everywhere).
"""

import numpy as np
import torch

from .._device import resolve_device
from ..dsl import compiler
from ..ops.linalg import cho_solve, cholesky_factor
from ..samplers.logprob import _bounds_arrays, _engine_note, \
    traceable_model_fn
from ..samplers.mcmc import _generator, make_mcmc_core
from .collectives import all_gather, pmean, pvary
from .mesh import shard, world_axis

__all__ = ["run_mcmc_sharded", "run_smc_sharded",
           "make_sharded_gp_log_prob_factory", "DIST_CHOL_MIN_N"]


# Data-sharded likelihoods at or above this N default onto the fully
# distributed (stripe-resident) Cholesky: below it, the replicated
# factorization is faster and the K-per-rank memory is immaterial.
DIST_CHOL_MIN_N = 8192


def make_sharded_gp_log_prob_factory(gp, x, y, yerr=0.0, data_axis="data",
                                     distributed_cholesky="auto",
                                     block_size=256, mesh=None, device=None):
    """Build a factory for data-sharded GP log-probs.

    Returns ``(factory, (x, y, yerr2))`` where the arrays are the *global*
    dataset (float64 host arrays; :func:`run_mcmc_sharded` shards them
    over ``data_axis``, or take a rank's rows with
    :func:`.mesh.shard`) and ``factory(x_local, y_local, yerr2_local) ->
    log_prob`` builds this rank's log-density: ``log_prob(theta_active)``
    maps (n,) -> scalar or (B, n) -> (B,), differentiable by autograd, the
    same value on every rank of the axis.

    With ``distributed_cholesky`` enabled — ``"auto"`` (the default)
    switches it on at N >= ``DIST_CHOL_MIN_N`` — the factorization itself
    runs sharded (:mod:`.dist_chol`).  Pass ``mesh`` so the dataset can be
    padded to a ``P * block_size`` multiple (otherwise N/P must already
    divide ``block_size``); without it the axis is every rank of the
    process group.  ``log_prob.engine`` is ``"dist_chol"`` or
    ``"sharded_replicated_chol"``.
    """
    device = mesh.device if mesh is not None else resolve_device(device)
    x_host = np.ascontiguousarray(gp.parse_samples(x), dtype=np.float64)
    y_host = np.asarray(y, dtype=np.float64)
    yerr2 = np.broadcast_to(np.asarray(yerr, np.float64) ** 2,
                            (len(x_host),)).copy()

    node = gp.kernel.spec_node()
    kernel_value = compiler._value_builder(node)

    n_mean = gp.mean.full_size
    n_wn = gp.white_noise.full_size
    theta_full0 = torch.as_tensor(
        gp.get_parameter_vector(include_frozen=True), device=device)
    unfrozen = torch.as_tensor(np.flatnonzero(gp.unfrozen_mask),
                               device=device)
    lo, hi = (torch.as_tensor(a, device=device) for a in _bounds_arrays(gp))
    n_real = x_host.shape[0]
    n_total = n_real
    norm_const = 0.5 * n_real * np.log(2.0 * np.pi)

    if distributed_cholesky == "auto":
        distributed_cholesky = n_real >= DIST_CHOL_MIN_N
        if distributed_cholesky and mesh is None:
            # Without the mesh the dataset cannot be padded to a
            # P * block_size multiple, and the local factorization rejects
            # non-divisible shards downstream — stay replicated, loudly
            # (pass mesh=, or distributed_cholesky=True for the unpadded
            # behavior when N / num_devices already divides block_size).
            distributed_cholesky = False
            _engine_note(
                "no mesh= was passed, so the dataset cannot be padded to "
                "a devices*block_size multiple at N={0}".format(n_real),
                what="data-sharded likelihood: using the replicated "
                     "factorization instead of the distributed Cholesky",
            )

    def axis_of():
        return mesh.axis(data_axis) if mesh is not None \
            else world_axis(data_axis)

    def full_theta(theta_active, axis, vary):
        """(theta (B, D), single, in_bounds); with ``vary`` theta enters
        the sharded code here (the distributed likelihood takes it in
        itself)."""
        single = theta_active.dim() == 1
        th_a = theta_active[None] if single else theta_active
        if vary:
            th_a = pvary(th_a, axis)
        theta = theta_full0.to(th_a.dtype).expand(th_a.shape[0], -1) \
            .index_copy(1, unfrozen, th_a)
        in_bounds = torch.all((theta >= lo) & (theta <= hi), dim=1)
        return theta, single, in_bounds

    def finish(ll, in_bounds, single):
        lp = torch.where(in_bounds, ll, torch.full_like(ll, -np.inf))
        lp = torch.where(torch.isnan(lp), torch.full_like(lp, -np.inf), lp)
        return lp[0] if single else lp

    if distributed_cholesky:
        from .dist_chol import distributed_loglike_fn

        if mesh is not None:
            step = mesh.shape[data_axis] * block_size
            n_total = -(-n_real // step) * step
            if n_total != n_real:
                pad = n_total - n_real
                x_host = np.concatenate(
                    [x_host, np.repeat(x_host[-1:], pad, axis=0)]
                )
                y_host = np.concatenate([y_host, np.zeros(pad)])
                yerr2 = np.concatenate([yerr2, np.ones(pad)])

        # Shape-polymorphic model fns only: the distributed likelihood
        # evaluates the mean on the padded global x and the white noise on
        # per-rank shards, so fixed-length baked constants cannot work.
        mean_fn = traceable_model_fn(gp.mean, x_host, device, torch.float64,
                                     allow_baked=False)
        wn_fn = traceable_model_fn(gp.white_noise, x_host, device,
                                   torch.float64, allow_baked=False)

        def factory(x_local, y_local, yerr2_local):
            def log_prob(theta_active):
                axis = axis_of()
                dist_ll = distributed_loglike_fn(
                    kernel_value, mean_fn, wn_fn, n_total, axis_name=axis,
                    block_size=block_size, n_real=n_real,
                )
                theta, single, in_bounds = full_theta(theta_active, axis,
                                                      False)
                x_l, y_l, e_l = (torch.as_tensor(a, device=device).to(
                    theta.dtype) for a in (x_local, y_local, yerr2_local))
                # One distributed factorization a chain (every rank runs
                # the same chains in the same order).
                ll = torch.stack([dist_ll(
                    th[n_mean + n_wn:], th[:n_mean], th[n_mean:n_mean + n_wn],
                    x_l, y_l, e_l) for th in theta])
                return finish(ll, in_bounds, single)

            log_prob.engine = "dist_chol"
            return log_prob

        return factory, (x_host, y_host, yerr2)

    # Replicated-factorization path: the model fns only ever see the
    # gathered global x, so baked host constants are fine.
    mean_fn = traceable_model_fn(gp.mean, x_host, device, torch.float64)
    wn_fn = traceable_model_fn(gp.white_noise, x_host, device, torch.float64)
    stripes = torch.func.vmap(kernel_value, in_dims=(0, None, None))

    def factory(x_local, y_local, yerr2_local):
        gathered = {}

        def log_prob(theta_active):
            axis = axis_of()
            theta, single, in_bounds = full_theta(theta_active, axis, True)
            x_l, y_l, e_l = (torch.as_tensor(a, device=device).to(
                theta.dtype) for a in (x_local, y_local, yerr2_local))
            th_mean = theta[:, :n_mean]
            th_wn = theta[:, n_mean:n_mean + n_wn]
            th_kernel = theta[:, n_mean + n_wn:]

            # Assemble the global inputs (N*d floats, gathered once a
            # dtype), build only the local column stripe, then gather
            # stripes into the replicated K for the (still replicated)
            # Cholesky.
            if theta.dtype not in gathered:
                gathered[theta.dtype] = tuple(all_gather(a, axis)
                                              for a in (x_l, y_l, e_l))
            x_full, y_full, yerr2_full = gathered[theta.dtype]
            stripe = stripes(th_kernel, x_full, x_l)      # (B, N, n_loc)
            # Gather stripes of rows of K^T -> columns of K; K is
            # symmetric, so this is K itself.
            K = all_gather(stripe.transpose(1, 2), axis, dim=1) \
                .transpose(1, 2)
            diag_noise = yerr2_full + torch.exp(wn_fn(th_wn, x_full))
            K = K + torch.diag_embed(torch.broadcast_to(diag_noise,
                                                        K.shape[:-1]))
            r = torch.broadcast_to(y_full - mean_fn(th_mean, x_full),
                                   K.shape[:-1])
            L, logdet = cholesky_factor(K)
            alpha = cho_solve(L, r)
            ll = -norm_const - 0.5 * (logdet + torch.sum(r * alpha, dim=-1))
            # The same on every rank, but built from each rank's stripe:
            # pmean makes autograd count it once (its backward hands each
            # rank 1/P of the cotangent, the pvary of theta sums the
            # ranks' parts).  Without it HMC on the data-sharded path would
            # use one rank's partial gradient.
            return finish(pmean(ll, axis), in_bounds, single)

        log_prob.engine = "sharded_replicated_chol"
        return log_prob

    return factory, (x_host, y_host, yerr2)


def _rank_generator(key, index, device):
    """Chain rank ``index``'s generator from the run's seed: ``fold_in``'s
    role in the JAX package (every rank's chains draw their own stream)."""
    if isinstance(key, torch.Generator):
        raise TypeError("run_mcmc_sharded takes an int seed (each rank "
                        "derives its own generator from it)")
    seed = np.random.SeedSequence([int(key), int(index)]).generate_state(
        1, np.uint64)[0]
    return _generator(int(seed) & 0x7FFFFFFFFFFFFFFF, device)


def run_mcmc_sharded(log_prob_factory, data, z0, key, mesh,
                     chain_axis="chains", data_axis=None, **mcmc_kwargs):
    """Chain-sharded (optionally data-sharded) MCMC over a mesh.

    Run on every rank of ``mesh``.

    :param log_prob_factory: either a batched ``log_prob`` (when ``data``
        is None) or a factory ``f(*local_data) -> log_prob`` called with
        this rank's shards of ``data`` along ``data_axis``.
    :param data: tuple of global data arrays, sharded along their first
        axis over ``data_axis`` (or None).
    :param z0: (chains, dim) global initial positions; the chains must
        divide over the ``chain_axis`` ranks.
    :param key: an int seed; chain rank i draws from a generator seeded by
        (key, i).
    :param mcmc_kwargs: :func:`george_tpu_torch.samplers.run_mcmc`'s
        options, and ``sync_every`` (the DA pooling cadence).
    :returns: :class:`MCMCResult` on every rank: the per-chain outputs of
        all chains (gathered over the chain axis, in its order), the pooled
        step size and mass matrix (the same bits on every rank), the
        warmup's accept means over all chains; ``num_evaluations`` counts
        this rank's batched value+gradient calls.

    The JAX package's ``check_vma`` has no counterpart: the collectives'
    transposes are fixed by :mod:`.collectives`.
    """
    chain = mesh.axis(chain_axis)
    z0 = torch.as_tensor(z0, device=mesh.device)
    num_chains, dim = z0.shape
    if num_chains % chain.size:
        raise ValueError(
            "num_chains={0} must divide over {1} devices".format(
                num_chains, chain.size
            )
        )
    z0_local = shard(z0, chain)
    if data is not None:
        axis = mesh.axis(data_axis)
        log_prob = log_prob_factory(*(shard(
            torch.as_tensor(d, device=mesh.device), axis) for d in data))
    else:
        log_prob = log_prob_factory
    core = make_mcmc_core(log_prob, z0_local.shape[0], dim, z0.dtype,
                          axis_name=chain, **mcmc_kwargs)
    res = core(z0_local, _rank_generator(key, chain.index, mesh.device))
    gathered = {f: all_gather(getattr(res, f), chain) for f in (
        "samples", "log_prob", "accept_prob", "diverging", "n_leapfrog")}
    return res._replace(
        warmup_accept_prob=pmean(res.warmup_accept_prob, chain), **gathered)


def run_smc_sharded(log_prob, log_init_prob, particles0, key, mesh,
                    particle_axis="particles", **smc_kwargs):
    """Particle-sharded adaptive-tempering SMC over a mesh.

    The cloud is replicated (the hyperparameter dimension is small); the
    O(n x model-cost) density evaluations shard over ``particle_axis`` and
    are gathered back, so temperatures, resampling and the random stream
    are those of :func:`george_tpu_torch.samplers.run_smc` on one device
    (the same ``key`` on every rank).  ``particles0.shape[0]`` must divide
    over the axis.
    """
    from ..samplers.smc import run_smc

    return run_smc(log_prob, log_init_prob, particles0, key,
                   axis_name=mesh.axis(particle_axis), device=mesh.device,
                   **smc_kwargs)
