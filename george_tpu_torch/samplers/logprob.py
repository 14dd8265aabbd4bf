# -*- coding: utf-8 -*-
"""GP hyperparameter posterior densities for the sampler layer.

:func:`build_gp_log_prob` turns a :class:`george_tpu_torch.GP` and a
dataset into a batched, differentiable ``log_prob(theta_active)`` and, where
a fused engine applies, attaches ``log_prob.batched_value_and_grad``: on the
state-space route the fused Kalman value+gradient, on the dense route the
fused dense value+gradient or, with ``config.dense_mxu_sampling``, the
blocked dense engine (each over CUDA kernels for tensors on the card, its
plain PyTorch version for tensors on the CPU), on the HODLR route the
level-batched factorization's value and one backward pass, wrapped with the
bounds prior, the NaN guards and the optional extra prior — the exact
semantics of ``vmap(value_and_grad(log_prob))``.
"""

import logging
import math
import warnings

import numpy as np
import torch

from .. import config
from .._device import resolve_device
from ..modeling import CallableModel, ConstantModel
from ..ops import dense, dense_mxu, hodlr_core, kalman
from ..ops import state_space as sskf

__all__ = ["build_gp_log_prob", "traceable_model_fn"]

_STATE_SPACE = ("state_space", "state_space_sequential",
                "state_space_parallel")


def traceable_model_fn(model, x_host, device, dtype, allow_baked=True):
    """Return ``f(params (B, p), x) -> (B, N) or (N,)`` for a mean /
    white-noise model.

    Supported forms, in this order (the JAX package's):
      * the model defines ``torch_value(params, x)`` (the documented hook
        for custom models, the counterpart of ``jax_value``): one chain's
        (p,) parameter tensor and the (N, d) inputs on the density's device
        to the (N,) values, in torch operations; applied over the chains
        with ``torch.func.vmap``, for any number of rows;
      * :class:`ConstantModel` (closed form, for any number of rows);
      * any model with *no active parameters* (its host value at
        ``x_host`` baked in; ``allow_baked=True`` only: callers that
        evaluate the model on other rows, e.g. a rank's shard on the
        distributed Cholesky path, pass ``allow_baked=False``);
      * a :class:`CallableModel` whose function takes a torch tensor.
    """
    if hasattr(model, "torch_value"):
        return torch.func.vmap(model.torch_value, in_dims=(0, None))
    n = len(x_host)
    if isinstance(model, ConstantModel):
        return lambda params, x: params[:, :1] + x.new_zeros(x.shape[0])
    if allow_baked and model.vector_size == 0:
        const = torch.as_tensor(
            np.broadcast_to(model.get_value(x_host), (n,)).copy(),
            device=device,
        ).to(dtype)
        return lambda params, x: const.to(params.dtype)
    if isinstance(model, CallableModel):
        return lambda params, x: model.function(x)
    raise TypeError(
        "model {0} has active parameters and no torch form{1}; define a "
        "torch_value(params, x) method".format(
            type(model).__name__, "" if allow_baked else
            " (baked host constants are not usable here: the model is "
            "evaluated on per-rank data shards)")
    )


def _bounds_arrays(gp):
    bounds = gp.get_parameter_bounds(include_frozen=True)
    lo = np.array(
        [-np.inf if b[0] is None else b[0] for b in bounds], dtype=np.float64
    )
    hi = np.array(
        [np.inf if b[1] is None else b[1] for b in bounds], dtype=np.float64
    )
    return lo, hi


def build_gp_log_prob(gp, x, y, yerr=0.0, log_prior=None, method="auto",
                      method_options=None, device=None, dtype=torch.float64):
    """Build a GP hyperparameter posterior as a batched torch function.

    :param gp: a :class:`george_tpu_torch.GP` (its *current* frozen
        parameters are baked in as constants).
    :param x,y,yerr: the dataset, as in :meth:`GP.compute`.
    :param log_prior: optional extra prior ``log_prior(theta_active (n,))
        -> scalar`` in torch operations (evaluated per chain with
        ``torch.func.vmap``), added on top of the bounds prior.
    :param method: ``"state_space"`` (or ``"state_space_sequential"``):
        the exact O(N) Kalman likelihood for 1-D Markovian kernels;
        ``"state_space_parallel"``: the same likelihood by the
        associative-scan filter (O(log N) depth); ``"dense"``: covariance
        build + Cholesky, O(N^3), for every kernel; ``"hodlr"``: the
        O(N log^2 N) hierarchical likelihood, approximate to its ``tol``,
        for kernels with no state-space form (see
        :func:`_build_hodlr_log_prob`); ``"auto"``: state-space where the
        kernel admits it, dense otherwise (``"hodlr"`` is opt-in because it
        is approximate).
    :param method_options: for ``"hodlr"``: ``min_size``, ``tol``,
        ``max_rank`` (the ``HODLRSolver`` knobs), ``rank_margin``,
        ``order`` and ``fixed_pivots``; an unknown option raises
        ``TypeError``.
    :param device: where the density is evaluated (default: the CUDA
        card; raises without one unless ``device="cpu"`` is given).
    :param dtype: the dtype of the returned ``theta0``.

    Returns ``(log_prob, theta0)``: ``log_prob(theta_active)`` maps (n,) ->
    scalar or (B, n) -> (B,), in the input's dtype, differentiable by
    autograd; ``theta0`` is the current active vector.  ``log_prob.engine``
    names what evaluates ``log_prob.batched_value_and_grad``.
    """
    device = resolve_device(device)
    if method not in ("auto", "dense", "hodlr") + _STATE_SPACE:
        raise ValueError("unknown method '{0}'".format(method))

    x_host = np.ascontiguousarray(gp.parse_samples(x), dtype=np.float64)
    y_host = np.asarray(y, dtype=np.float64)
    yerr2 = np.broadcast_to(
        np.asarray(yerr, dtype=np.float64) ** 2, (len(x_host),)
    )
    node = gp.kernel.spec_node()
    usable = x_host.shape[1] == 1 and sskf.supports_state_space(node)
    if method in _STATE_SPACE and not usable:
        raise sskf.StateSpaceUnsupported(
            "kernel/inputs have no exact state-space form; use "
            "method='dense'"
        )
    if method == "hodlr":
        log_prob = _build_hodlr_log_prob(
            gp, node, x_host, y_host, yerr2, log_prior, device,
            dict(method_options or {}))
    elif method != "dense" and usable:
        log_prob = _build_state_space_log_prob(
            gp, node, x_host, y_host, yerr2, log_prior, device,
            parallel=method == "state_space_parallel"
        )
    else:
        log_prob = _build_dense_log_prob(
            gp, node, x_host, y_host, yerr2, log_prior, device
        )
    theta0 = torch.as_tensor(gp.get_parameter_vector(),
                             device=device).to(dtype)
    return log_prob, theta0


def _prior_value_and_grad(log_prior, thetas):
    grads, values = torch.func.vmap(torch.func.grad_and_value(log_prior))(
        thetas
    )
    return values, grads


def _posterior(gp, x_host, host, log_prior, device, loglike):
    """The batched ``log_prob(theta_active)`` over a likelihood.

    :param host: the dataset as float64 host arrays, cast once per dtype.
    :param loglike: ``(kernel parameters (B, P), data, mean, log white
        noise) -> ll (B,)``, differentiable by autograd; the mean and the
        log white noise are (B, N) or (N,).
    Returns ``(log_prob, theta_full0, unfrozen, lo, hi)``.
    """
    mean_fn = traceable_model_fn(gp.mean, x_host, device, torch.float64)
    wn_fn = traceable_model_fn(gp.white_noise, x_host, device, torch.float64)
    n_mean = gp.mean.full_size
    n_wn = gp.white_noise.full_size
    theta_full0 = torch.as_tensor(
        gp.get_parameter_vector(include_frozen=True), device=device
    )
    unfrozen = torch.as_tensor(np.flatnonzero(gp.unfrozen_mask),
                               device=device)
    lo, hi = (torch.as_tensor(a, device=device) for a in _bounds_arrays(gp))
    cache = {}

    def data(dtype):
        if dtype not in cache:
            cache[dtype] = {k: torch.tensor(v, device=device).to(dtype)
                            for k, v in host.items()}
        return cache[dtype]

    def log_prob(theta_active):
        single = theta_active.dim() == 1
        th_a = theta_active[None] if single else theta_active
        d = data(th_a.dtype)
        theta = theta_full0.to(th_a.dtype).expand(th_a.shape[0], -1) \
            .index_copy(1, unfrozen, th_a)
        in_bounds = torch.all((theta >= lo) & (theta <= hi), dim=1)
        mean = mean_fn(theta[:, :n_mean], d["x"])
        log_wn = wn_fn(theta[:, n_mean:n_mean + n_wn], d["x"])
        ll = loglike(theta[:, n_mean + n_wn:], d, mean, log_wn)

        lp = torch.where(in_bounds, ll, torch.full_like(ll, -np.inf))
        if log_prior is not None:
            lp = lp + torch.func.vmap(log_prior)(th_a).to(lp.dtype)
        # NaN (failed filter or factorization) and +inf (an exactly zero
        # pivot) both read as rejected proposals.
        lp = torch.where(lp < np.inf, lp, torch.full_like(lp, -np.inf))
        return lp[0] if single else lp

    return log_prob, theta_full0, unfrozen, lo, hi


def _build_state_space_log_prob(gp, node, x_host, y_host, yerr2, log_prior,
                                device, parallel=False):
    """O(N) Kalman-filter posterior density (1-D Markovian kernels): the
    sequential filter, or with ``parallel`` the associative-scan filter.
    Either way the batched value+gradient is the fused Kalman engine's, as
    the JAX package attaches its Pallas kernel for both methods."""
    # The marginal likelihood is permutation-invariant; the filter needs
    # time-ordered inputs.
    order = np.argsort(x_host[:, 0], kind="stable")
    t_host = x_host[order, 0]
    y_sorted = y_host[order]
    yerr2_sorted = yerr2[order]
    x_sorted = x_host[order]
    terms = sskf.extract_terms(node)

    filter_ll = sskf.kalman_loglike_parallel if parallel \
        else sskf.kalman_loglike

    def loglike(th_kernel, d, mean, log_wn):
        return filter_ll(terms, th_kernel, d["dt"], d["y"] - mean,
                         d["yerr2"] + torch.exp(log_wn))

    host = dict(dt=np.diff(t_host), x=x_sorted, y=y_sorted, yerr2=yerr2_sorted)
    log_prob, theta_full0, unfrozen, lo, hi = _posterior(
        gp, x_sorted, host, log_prior, device, loglike)
    log_prob.engine = "torch_state_space" + ("_parallel" if parallel else "")
    if len(t_host) > kalman.MAX_N:
        _engine_note("N={0} > {1}".format(len(t_host), kalman.MAX_N),
                     what="state-space sampler path: falling back to the "
                          "plain filter")
        return log_prob
    # The fused Kalman value+gradient takes mean and white noise each either
    # parameter-free (values baked into the data) or a ConstantModel scalar.
    n_mean, y_eff = _scalar_or_baked(gp.mean, x_sorted, y_sorted,
                                     lambda y, m: y - m)
    n_wn, v_eff = _scalar_or_baked(gp.white_noise, x_sorted, yerr2_sorted,
                                   lambda v, w: v + np.exp(w))
    if n_mean is None or n_wn is None:
        _engine_note("{0} model is neither a scalar ConstantModel nor "
                     "parameter-free".format(
                         "mean" if n_mean is None else "white-noise"),
                     what="state-space sampler path: falling back to the "
                          "plain filter")
        return log_prob
    active = tuple(int(i) for i in unfrozen.tolist())
    vg_core = kalman.make_kalman_vg(
        node, t_host, y_eff, v_eff, n_mean, n_wn, active,
    )
    log_prob.batched_value_and_grad = _finish_batched_vg(
        vg_core, theta_full0, unfrozen, lo, hi, log_prior
    )
    log_prob.kalman_vg = vg_core
    log_prob.engine = "cuda_kalman" if device.type == "cuda" \
        else "torch_kalman"
    return log_prob


def _build_dense_log_prob(gp, node, x_host, y_host, yerr2, log_prior,
                          device):
    """Dense posterior density: covariance build + Cholesky, O(N^3), for
    every kernel (the JAX package's ``xla_dense`` route)."""
    def loglike(th_kernel, d, mean, log_wn):
        return dense.gp_loglike(node, th_kernel, d["x"], d["y"] - mean,
                                d["yerr2"] + torch.exp(log_wn))

    host = dict(x=x_host, y=y_host, yerr2=yerr2)
    log_prob, theta_full0, unfrozen, lo, hi = _posterior(
        gp, x_host, host, log_prior, device, loglike)
    log_prob.engine = "torch_dense_autograd"
    _attach_dense_vg(log_prob, gp, node, x_host, y_host, yerr2, theta_full0,
                     unfrozen, lo, hi, log_prior, device)
    return log_prob


def _scalar_or_baked(model, x, base, transform):
    """ConstantModel scalar -> (1, base); parameter-free -> (0, baked).

    Anything else returns (None, None): the fused engines take the full
    parameter vector laid out [mean (<= 1) | white noise (<= 1) | kernel],
    so a mean / noise model with more (even frozen) parameters does not fit.
    """
    if isinstance(model, ConstantModel) and model.full_size == 1:
        return 1, np.asarray(base)
    if model.full_size == 0:
        vals = np.broadcast_to(model.get_value(x), (len(x),))
        return 0, transform(np.asarray(base), vals)
    return None, None


def _engine_note(reason, what="dense sampler path: falling back to the "
                              "plain batched value_and_grad"):
    """One-line, config-gated notice that a posterior fell out of a fused
    engine's envelope onto the plain route."""
    if config.engine_log:
        logging.getLogger("george_tpu_torch").warning(
            "%s (%s); set config.engine_log=False to silence", what, reason,
        )


def _attach_dense_vg(log_prob, gp, node, x_host, y_host, yerr2, theta_full0,
                     unfrozen, lo, hi, log_prior, device):
    """Attach a fused batched dense value+gradient where one applies (the
    JAX package's ``_attach_pallas_dense_vg``, same envelopes and notes):

      * the fused engine (:mod:`..ops.dense`) for N below
        ``config.dense_mxu_min_n`` and metric types 0/1, and over its whole
        envelope (N <= 256) while ``config.dense_mxu_sampling`` is off;
      * with ``config.dense_mxu_sampling`` on, the blocked engine
        (:mod:`..ops.dense_mxu`) for N up to 512 wherever the fused one is
        not taken: from ``dense_mxu_min_n`` for metric types 0/1, at any
        N for the general metric.

    Both require mean and white noise scalar or parameter-free.
    """
    if config.pallas_dense == "never":
        return
    if config.pallas_dense != "auto":
        raise ValueError("config.pallas_dense must be 'auto' or 'never', got "
                         "{0!r}".format(config.pallas_dense))
    n = len(x_host)
    mxu_ok = config.dense_mxu_sampling and dense_mxu.supports_dense_mxu(node,
                                                                        n)
    fused = dense.supports_dense(node, n) \
        and (n < config.dense_mxu_min_n or not mxu_ok)
    if not fused and not mxu_ok:
        _engine_note(
            "N={0} is outside the VPU kernel envelope and "
            "config.dense_mxu_sampling is off (the MXU engine's "
            "posterior-moment envelope is still open)".format(n)
        )
        return
    n_mean, y_eff = _scalar_or_baked(gp.mean, x_host, y_host,
                                     lambda y, m: y - m)
    if n_mean is None:
        _engine_note("mean model is neither a scalar ConstantModel nor "
                     "parameter-free")
        return
    n_wn, v_eff = _scalar_or_baked(gp.white_noise, x_host, yerr2,
                                   lambda v, w: v + np.exp(w))
    if n_wn is None:
        _engine_note("white-noise model is neither a scalar ConstantModel "
                     "nor parameter-free")
        return
    active = tuple(int(i) for i in unfrozen.tolist())
    if not active:
        return
    if fused:
        vg_core = dense.make_dense_batched_vg(node, x_host, y_eff, v_eff,
                                              n_mean, n_wn, active)
        log_prob.dense_vg = vg_core
        engine = "dense"
    else:
        vg_core = dense_mxu.make_dense_mxu_vg(node, x_host, y_eff, v_eff,
                                              n_mean, n_wn, active)
        log_prob.dense_mxu_vg = vg_core
        engine = "dense_mxu"
    log_prob.batched_value_and_grad = _finish_batched_vg(
        vg_core, theta_full0, unfrozen, lo, hi, log_prior
    )
    log_prob.engine = ("cuda_" if device.type == "cuda" else "torch_") \
        + engine


def _finish_batched_vg(vg_core, theta_full0, unfrozen, lo, hi, log_prior):
    """Wrap a fused ``(theta_full (B, D)) -> (ll, grad_active)`` engine with
    the bounds prior, NaN->(-inf, 0) guards, and the optional extra prior —
    the exact semantics of ``vmap(value_and_grad(log_prob))``."""

    def batched_value_and_grad(thetas_active):
        """(B, n_active) -> (lp (B,), d lp / d theta (B, n_active))."""
        dtype = thetas_active.dtype
        theta = theta_full0.to(dtype).expand(thetas_active.shape[0], -1) \
            .index_copy(1, unfrozen, thetas_active).contiguous()
        ll, grad = vg_core(theta)
        in_bounds = torch.all((theta >= lo) & (theta <= hi), dim=1)
        neg_inf = torch.full_like(ll, -np.inf)
        # NaN (failed filter) AND +inf both read as rejected proposals.
        ll = torch.where(ll < np.inf, ll, neg_inf)
        ok = in_bounds & torch.isfinite(ll)
        lp = torch.where(in_bounds, ll, neg_inf)
        g = torch.where(ok[:, None], grad, torch.zeros_like(grad))
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        if log_prior is not None:
            pv, pg = _prior_value_and_grad(log_prior, thetas_active)
            lp = lp + pv.to(dtype)
            g = g + pg.to(dtype)
        # Same final guard as log_prob: NaN (e.g. a NaN prior, or -inf
        # likelihood + +inf prior) reads as a rejected proposal.
        lp = torch.where(lp < np.inf, lp, neg_inf)
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        return lp, g

    return batched_value_and_grad


def _build_hodlr_log_prob(gp, node, x_host, y_host, yerr2, log_prior, device,
                          opts):
    """O(N log^2 N) HODLR posterior density for the sampler layer.

    The level-batched factorization (``ops/hodlr_core.py``) runs for every
    chain at once, never an N x N matrix, and one backward pass through it
    gives every chain's gradient (see ``ops/hodlr_core``'s docstring for
    why reverse mode, where the JAX package takes one ``jvp`` a
    parameter).

    The plan and per-block ranks are pinned host-side: one rank-adaptive
    factorization at the GP's current parameters (``hodlr_compute``, with
    its escalation on saturation), every rank then multiplied by
    ``rank_margin`` (default 2, capped at the block size) so that the
    compression stays inside tolerance as the sampler moves.  With
    ``fixed_pivots`` (default) the ACA pivots are recorded once there at a
    100x tighter tolerance and replayed with a damped reciprocal, which
    makes the density a smooth deterministic function of theta; a record
    that saturates its ranks warns, as ``hodlr_compute`` does.  Without
    it, each evaluation pivots adaptively per chain.  ``min_size`` /
    ``tol`` / ``max_rank`` / ``order`` are the ``HODLRSolver``'s.

    Likelihoods are approximate to ``tol``.  The port's float64 is the
    default type (the float32 gradients carry the compression's noise).
    """
    from ..solvers.hodlr import HODLRSolver

    min_size = int(opts.pop("min_size", 100))
    tol = float(opts.pop("tol", 0.1))
    max_rank = opts.pop("max_rank", None)
    rank_margin = float(opts.pop("rank_margin", 2.0))
    order = opts.pop("order", "auto")
    fixed_pivots = bool(opts.pop("fixed_pivots", True))
    if opts:
        raise TypeError(
            "unknown hodlr method_options: {0}".format(sorted(opts)))

    # The solver's internal ordering; the likelihood is
    # permutation-invariant.
    solver = HODLRSolver(gp.kernel, min_size=min_size, tol=tol,
                         max_rank=max_rank, order=order, device=device)
    perm = solver._ordering(x_host)
    if perm is not None:
        x_host, y_host, yerr2 = x_host[perm], y_host[perm], yerr2[perm]

    theta_k0 = gp.kernel.get_parameter_vector(include_frozen=True)
    wn0 = np.broadcast_to(np.exp(gp.white_noise.get_value(
        gp._model_input(x_host))), (len(x_host),))
    fact0 = hodlr_core.hodlr_compute(
        node, theta_k0, x_host, yerr2 + wn0, min_size=min_size, tol=tol,
        max_rank=max_rank, device=device)
    levels, leaf_size, n_pad = fact0.levels, fact0.leaf_size, fact0.n_pad
    full = tuple(n_pad >> (q + 1) for q in range(levels))
    ranks = tuple(min(full[q], int(math.ceil(rank_margin * fact0.ranks[q])))
                  for q in range(levels))
    n = len(x_host)
    valid = torch.arange(n_pad, device=device) < n
    x_pad64 = hodlr_core._pad_points(
        torch.as_tensor(x_host, device=device), n_pad)

    pivots = None
    if fixed_pivots:
        pivots, saturated, ranks = hodlr_core.record_pivots(
            node, torch.as_tensor(theta_k0, device=device), x_pad64, valid,
            levels, ranks, tol * 1e-2)
        if saturated:
            warnings.warn(
                "HODLR pivot record at tol={0} saturated its rank caps; the "
                "replayed density is approximate beyond them (raise "
                "rank_margin)".format(tol * 1e-2))
    compute = hodlr_core._compute_all_fn(
        node, levels, leaf_size, ranks,
        pivot_mode="fixed" if fixed_pivots else "replay")
    x_pads = {}
    norm_const = 0.5 * n * math.log(2.0 * math.pi)

    def ll_core(th_kernel, r, noise):
        """(B, P), (B or 1, N), (B, N) -> ll (B,), differentiable."""
        dt = th_kernel.dtype
        if dt not in x_pads:
            x_pads[dt] = x_pad64.to(dt)
        x_pad = x_pads[dt]
        r_pad = hodlr_core._pad_vector(r, n_pad, 0.0)
        diag_pad = hodlr_core._pad_vector(noise, n_pad, 1.0)
        piv = pivots
        with hodlr_core.fp32_matmuls():
            if piv is None:
                # Each chain's own adaptive pivots, replayed with the plain
                # reciprocal.
                with torch.no_grad():
                    piv, _ = hodlr_core.adaptive_pivots(
                        node, th_kernel.detach(), x_pad, valid, levels,
                        ranks, tol)
            ll, _ = hodlr_core.hodlr_loglike(compute, th_kernel, x_pad, r_pad,
                                             diag_pad, valid, tol, piv)
        return ll - norm_const

    def loglike(th_kernel, d, mean, log_wn):
        noise = (d["yerr2"] + torch.exp(log_wn)).expand(th_kernel.shape[0],
                                                         -1)
        return ll_core(th_kernel, d["y"] - mean, noise)

    host = dict(x=x_host, y=y_host, yerr2=yerr2)
    log_prob, theta_full0, unfrozen, lo, hi = _posterior(
        gp, x_host, host, log_prior, device, loglike)
    mean_fn = traceable_model_fn(gp.mean, x_host, device, torch.float64)
    wn_fn = traceable_model_fn(gp.white_noise, x_host, device, torch.float64)
    n_mean = gp.mean.full_size
    n_wn = gp.white_noise.full_size
    data = {}

    def vg_core(theta_full):
        """(B, D) -> (ll (B,), d ll / d theta_active (B, n_active)): the
        value, then one backward pass for every chain and parameter."""
        dt = theta_full.dtype
        if dt not in data:
            data[dt] = {k: torch.tensor(v, device=device).to(dt)
                        for k, v in host.items()}
        d = data[dt]
        with torch.enable_grad():
            th = theta_full.detach().requires_grad_(True)
            mean = mean_fn(th[:, :n_mean], d["x"])
            log_wn = wn_fn(th[:, n_mean:n_mean + n_wn], d["x"])
            ll = loglike(th[:, n_mean + n_wn:], d, mean, log_wn)
            grad, = torch.autograd.grad(ll.sum(), th)
        return ll.detach(), grad[:, unfrozen]

    log_prob.batched_value_and_grad = _finish_batched_vg(
        vg_core, theta_full0, unfrozen, lo, hi, log_prior)
    log_prob.hodlr_vg = vg_core
    log_prob.hodlr_ranks = ranks
    log_prob.engine = "hodlr"
    return log_prob

