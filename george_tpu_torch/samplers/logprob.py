# -*- coding: utf-8 -*-
"""GP hyperparameter posterior densities for the sampler layer.

:func:`build_gp_log_prob` turns a :class:`george_tpu_torch.GP` and a
dataset into a batched, differentiable ``log_prob(theta_active)`` and, on
the state-space route, attaches ``log_prob.batched_value_and_grad``: the
fused Kalman value+gradient (the CUDA kernel for tensors on the card, its
plain PyTorch version for tensors on the CPU) wrapped with the bounds
prior, the NaN guards and the optional extra prior — the exact semantics of
``vmap(value_and_grad(log_prob))``.
"""

import logging

import numpy as np
import torch

from .._device import resolve_device
from ..modeling import CallableModel, ConstantModel
from ..ops import kalman
from ..ops import state_space as sskf

__all__ = ["build_gp_log_prob", "traceable_model_fn"]

_NOT_PORTED = {
    "dense": "the dense sampler route (ROADMAP Queue A 'Dense sampler "
             "route', which needs the pallas_dense kernel of Queue B)",
    "state_space_parallel": "the associative-scan filter (ROADMAP Queue A "
                            "'Rest of the state space')",
    "hodlr": "the HODLR engine (ROADMAP Queue A 'HODLR')",
}


def traceable_model_fn(model, x_host, device, dtype):
    """Return ``f(params (B, p), x) -> (B, N) or (N,)`` for a mean /
    white-noise model.

    Supported forms: :class:`ConstantModel` (closed form); any model with
    *no active parameters* (its host value at ``x_host`` baked in); a
    :class:`CallableModel` whose function takes a torch tensor.
    """
    n = len(x_host)
    if isinstance(model, ConstantModel):
        return lambda params, x: params[:, :1] + x.new_zeros(n)
    if model.vector_size == 0:
        const = torch.as_tensor(
            np.broadcast_to(model.get_value(x_host), (n,)).copy(),
            device=device,
        ).to(dtype)
        return lambda params, x: const.to(params.dtype)
    if isinstance(model, CallableModel):
        return lambda params, x: model.function(x)
    raise TypeError(
        "model {0} has active parameters and no torch form; use a "
        "ConstantModel or a parameter-free model".format(type(model).__name__)
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
                      device=None, dtype=torch.float64):
    """Build a GP hyperparameter posterior as a batched torch function.

    :param gp: a :class:`george_tpu_torch.GP` (its *current* frozen
        parameters are baked in as constants).
    :param x,y,yerr: the dataset, as in :meth:`GP.compute`.
    :param log_prior: optional extra prior ``log_prior(theta_active (n,))
        -> scalar`` in torch operations (evaluated per chain with
        ``torch.func.vmap``), added on top of the bounds prior.
    :param method: ``"auto"`` or ``"state_space"``: the exact O(N) Kalman
        likelihood for 1-D Markovian kernels.  The dense, associative-scan
        and HODLR routes come with later slices and raise
        ``NotImplementedError``; so does ``"auto"`` for a kernel without a
        state-space form.
    :param device: where the density is evaluated (default: the CUDA
        card; raises without one unless ``device="cpu"`` is given).
    :param dtype: the dtype of the returned ``theta0``.

    Returns ``(log_prob, theta0)``: ``log_prob(theta_active)`` maps (n,) ->
    scalar or (B, n) -> (B,), in the input's dtype, differentiable by
    autograd; ``theta0`` is the current active vector.  ``log_prob.engine``
    names what evaluates ``log_prob.batched_value_and_grad``.
    """
    device = resolve_device(device)
    if method in _NOT_PORTED:
        raise NotImplementedError(
            "method '{0}' is not ported yet: {1}".format(
                method, _NOT_PORTED[method])
        )
    if method not in ("auto", "state_space", "state_space_sequential"):
        raise ValueError("unknown method '{0}'".format(method))

    x_host = np.ascontiguousarray(gp.parse_samples(x), dtype=np.float64)
    y_host = np.asarray(y, dtype=np.float64)
    yerr2 = np.broadcast_to(
        np.asarray(yerr, dtype=np.float64) ** 2, (len(x_host),)
    )
    node = gp.kernel.spec_node()
    usable = x_host.shape[1] == 1 and sskf.supports_state_space(node)
    if not usable:
        if method != "auto":
            raise sskf.StateSpaceUnsupported(
                "kernel/inputs have no exact state-space form"
            )
        raise NotImplementedError(
            "kernel/inputs have no exact state-space form, and "
            + _NOT_PORTED["dense"] + " is not ported yet"
        )
    log_prob = _build_state_space_log_prob(
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


def _build_state_space_log_prob(gp, node, x_host, y_host, yerr2, log_prior,
                                device):
    """O(N) Kalman-filter posterior density (1-D Markovian kernels)."""
    # The marginal likelihood is permutation-invariant; the filter needs
    # time-ordered inputs.
    order = np.argsort(x_host[:, 0], kind="stable")
    t_host = x_host[order, 0]
    y_sorted = y_host[order]
    yerr2_sorted = yerr2[order]
    x_sorted = x_host[order]

    terms = sskf.extract_terms(node)
    f64 = torch.float64
    mean_fn = traceable_model_fn(gp.mean, x_sorted, device, f64)
    wn_fn = traceable_model_fn(gp.white_noise, x_sorted, device, f64)

    n_mean = gp.mean.full_size
    n_wn = gp.white_noise.full_size
    theta_full0 = torch.as_tensor(
        gp.get_parameter_vector(include_frozen=True), device=device
    )
    unfrozen = torch.as_tensor(np.flatnonzero(gp.unfrozen_mask),
                               device=device)
    lo, hi = (torch.as_tensor(a, device=device) for a in _bounds_arrays(gp))
    host = dict(dt=np.diff(t_host), x=x_sorted, y=y_sorted, yerr2=yerr2_sorted)
    cache = {}

    def data(dtype):
        if dtype not in cache:
            cache[dtype] = {k: torch.as_tensor(v, device=device).to(dtype)
                            for k, v in host.items()}
        return cache[dtype]

    def log_prob(theta_active):
        single = theta_active.dim() == 1
        th_a = theta_active[None] if single else theta_active
        d = data(th_a.dtype)
        theta = theta_full0.to(th_a.dtype).expand(th_a.shape[0], -1) \
            .index_copy(1, unfrozen, th_a)
        in_bounds = torch.all((theta >= lo) & (theta <= hi), dim=1)

        th_mean = theta[:, :n_mean]
        th_wn = theta[:, n_mean:n_mean + n_wn]
        th_kernel = theta[:, n_mean + n_wn:]
        r = d["y"] - mean_fn(th_mean, d["x"])
        v = d["yerr2"] + torch.exp(wn_fn(th_wn, d["x"]))
        ll = sskf.kalman_loglike(terms, th_kernel, d["dt"], r, v)

        lp = torch.where(in_bounds, ll, torch.full_like(ll, -np.inf))
        if log_prior is not None:
            lp = lp + torch.func.vmap(log_prior)(th_a).to(lp.dtype)
        # NaN (failed filter) and +inf both read as rejected proposals.
        lp = torch.where(lp < np.inf, lp, torch.full_like(lp, -np.inf))
        return lp[0] if single else lp

    log_prob.engine = "torch_state_space"
    _attach_kalman_vg(
        log_prob, gp, node, t_host, y_sorted, yerr2_sorted, x_sorted,
        theta_full0, unfrozen, lo, hi, log_prior, device,
    )
    return log_prob


def _attach_kalman_vg(log_prob, gp, node, t_host, y_sorted, yerr2_sorted,
                      x_sorted, theta_full0, unfrozen, lo, hi, log_prior,
                      device):
    """Attach ``log_prob.batched_value_and_grad`` through the fused Kalman
    value+gradient when the model shapes fit its parameter layout: mean and
    white noise each either parameter-free (values baked into the data) or
    a :class:`ConstantModel` scalar (frozen or trainable)."""
    if len(t_host) > kalman.MAX_N:
        if device.type == "cuda":
            # The reference streams such a series through a Pallas kernel;
            # on the card the port has no kernel for it yet, and the plain
            # filter must not stand in for one.
            raise NotImplementedError(
                "N={0} > {1}: the streaming Kalman kernel (ROADMAP Queue B "
                "1, pallas_kalman._kernel_builder_streaming) is not ported "
                "yet; use device='cpu' for the plain filter".format(
                    len(t_host), kalman.MAX_N))
        logging.getLogger("george_tpu_torch").warning(
            "N=%d > %d: the fused Kalman engine does not take this series "
            "yet; gradients run through autograd of the plain filter",
            len(t_host), kalman.MAX_N,
        )
        return
    mean, wn = gp.mean, gp.white_noise
    if isinstance(mean, ConstantModel) and mean.full_size == 1:
        n_mean, y_eff = 1, np.asarray(y_sorted)
    elif mean.full_size == 0:
        n_mean = 0
        y_eff = np.asarray(y_sorted) - np.broadcast_to(
            mean.get_value(x_sorted), (len(x_sorted),)
        )
    else:
        return
    if isinstance(wn, ConstantModel) and wn.full_size == 1:
        n_wn, v_eff = 1, np.asarray(yerr2_sorted)
    elif wn.full_size == 0:
        n_wn = 0
        v_eff = np.asarray(yerr2_sorted) + np.exp(np.broadcast_to(
            wn.get_value(x_sorted), (len(x_sorted),)
        ))
    else:
        return

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
