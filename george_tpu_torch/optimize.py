# -*- coding: utf-8 -*-
"""Batched multi-restart L-BFGS for GP hyperparameters.

george's documented flow optimizes with ``scipy.optimize.minimize`` over
``gp.nll`` / ``gp.grad_nll``: one factorization a function evaluation,
restarts one after another.  Here every restart runs at once: the objective
is the batched value and gradient of the GP's marginal likelihood that the
samplers use (:func:`george_tpu_torch.samplers.build_gp_log_prob`: on the
state-space route one launch of the Kalman value+gradient kernel a
evaluation for all restarts together, on the dense route the dense kernel),
and the optimizer is L-BFGS in plain PyTorch over (restarts, dim) tensors:
the two-loop recursion over a (restarts, memory, dim) history, and a line
search under the strong Wolfe conditions (bracketing, then a zoom by
safeguarded quadratic interpolation), each restart in its own phase under
masks.  A restart that has converged or stalled is frozen, as the samplers
freeze finished chains; it is still evaluated with the batch.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .samplers.logprob import build_gp_log_prob

__all__ = ["minimize", "OptimizeResult"]

# The strong Wolfe constants (sufficient decrease, curvature) and the line
# search's evaluations a step.
C1 = 1e-4
C2 = 0.9
MAX_LINE_EVALS = 30
MAX_STEP = 1e10


@dataclass
class OptimizeResult:
    """The fields of scipy's result that george's tutorials read, and the
    batch's own."""

    x: np.ndarray          # best active-parameter vector
    fun: float             # objective (NLL or -log-posterior) at ``x``
    grad_norm: float       # |d fun / d x| at ``x`` (inf-norm)
    nit: int               # L-BFGS iterations of the winning restart
    success: bool          # stopped before ``max_iters`` at a finite optimum
    restart_funs: np.ndarray = None   # each restart's final objective
    restart_x0: np.ndarray = None     # each restart's starting vector
    evaluations: int = 0   # batched value+gradient calls

    def __repr__(self):
        return ("OptimizeResult(fun={0:.9g}, grad_norm={1:.3g}, nit={2}, "
                "success={3})".format(self.fun, self.grad_norm, self.nit,
                                      self.success))


def _objective(log_prob):
    """``f(x (B, n)) -> (value (B,), gradient (B, n))`` of the negative
    log-density: the density's batched value+gradient where a fused engine
    is attached, else autograd through ``log_prob``.  Rejected points
    (out of bounds, a failed factorization) read +inf with a zero
    gradient."""
    vg = getattr(log_prob, "batched_value_and_grad", None)

    def fun(x):
        if vg is not None:
            lp, g = vg(x)
        else:
            with torch.enable_grad():
                xr = x.detach().requires_grad_(True)
                lp = log_prob(xr)
                g = torch.autograd.grad(lp.sum(), xr)[0]
            lp = lp.detach()
        ok = torch.isfinite(lp)[:, None] & ~torch.isnan(g)
        return -lp, torch.where(ok, -g, torch.zeros_like(g))

    return fun


def _two_loop(g, S, Y, rho):
    """The L-BFGS direction ``-H g`` per row; the history (B, m, n) holds
    the newest pair last, and unused slots have rho = 0."""
    m = S.shape[1]
    q = g
    alphas = []
    for i in range(m - 1, -1, -1):
        a = rho[:, i] * torch.sum(S[:, i] * q, dim=-1)
        q = q - a[:, None] * Y[:, i]
        alphas.append(a)
    sy = torch.sum(S[:, -1] * Y[:, -1], dim=-1)
    yy = torch.sum(Y[:, -1] * Y[:, -1], dim=-1)
    gamma = torch.where(rho[:, -1] > 0, sy / torch.where(yy > 0, yy, 1.0),
                        torch.ones_like(sy))
    r = gamma[:, None] * q
    for i in range(m):
        b = rho[:, i] * torch.sum(Y[:, i] * r, dim=-1)
        r = r + S[:, i] * (alphas[m - 1 - i] - b)[:, None]
    return -r


def _zoom_step(lo, hi, f_lo, f_hi, dphi_lo):
    """A trial step inside [lo, hi]: the minimum of the quadratic through
    (lo, f_lo, dphi_lo) and (hi, f_hi), kept 10% away from both ends, or
    the midpoint."""
    width = hi - lo
    curv = f_hi - f_lo - dphi_lo * width
    quad = lo - dphi_lo * width * width / (2.0 * curv)
    a_min = torch.minimum(lo, hi) + 0.1 * width.abs()
    a_max = torch.maximum(lo, hi) - 0.1 * width.abs()
    good = torch.isfinite(quad) & (curv > 0) & (quad >= a_min) & \
        (quad <= a_max)
    return torch.where(good, quad, 0.5 * (lo + hi))


def _line_search(fun, x, f0, g0, d, a0, live, counter):
    """Steps along ``d`` under the strong Wolfe conditions, every row in its
    own phase (0 bracketing, 1 zooming, 2 accepted, 3 failed).

    Returns ``(a, f, g, ok)``: the accepted step, the objective and gradient
    there, and which rows found one.  A row that runs out of evaluations
    takes the best sufficient-decrease point it saw, if any.
    """
    dphi0 = torch.sum(g0 * d, dim=-1)
    phase = torch.where(live, 0, 3)
    zeros = torch.zeros_like(f0)
    a_prev, f_prev, dphi_prev, g_prev = zeros, f0, dphi0, g0
    a_cur = a0
    lo, hi, f_lo, f_hi, dphi_lo, g_lo = zeros, zeros, f0, f0, dphi0, g0
    a_acc, f_acc, g_acc = zeros, f0, g0
    brackets = torch.zeros_like(phase)
    tiny = torch.finfo(f0.dtype).eps

    def pick(mask, new, old):
        return torch.where(mask[:, None] if new.dim() == 2 else mask, new,
                           old)

    for _ in range(MAX_LINE_EVALS):
        # A zoom whose interval has collapsed ends at its low end.
        collapsed = (phase == 1) & ((hi - lo).abs() <= tiny * torch.maximum(
            lo.abs(), torch.ones_like(lo)))
        take_lo = collapsed & (lo > 0)
        a_acc, f_acc, g_acc = (pick(take_lo, lo, a_acc),
                               pick(take_lo, f_lo, f_acc),
                               pick(take_lo, g_lo, g_acc))
        phase = torch.where(take_lo, 2, torch.where(collapsed, 3, phase))
        work = phase < 2
        if not bool(work.any()):
            break
        a = torch.where(phase == 0, a_cur,
                        _zoom_step(lo, hi, f_lo, f_hi, dphi_lo))
        a = torch.where(work, a, zeros)
        f, g = fun(x + a[:, None] * d)
        counter[0] += 1
        dphi = torch.sum(g * d, dim=-1)
        no_decrease = ~(f <= f0 + C1 * a * dphi0)
        curvature = dphi.abs() <= -C2 * dphi0

        br = work & (phase == 0)
        zm = work & (phase == 1)
        # Bracketing: a step past the minimum starts a zoom.
        b_up = br & (no_decrease | ((brackets > 0) & (f >= f_prev)))
        b_done = br & ~b_up & curvature
        b_down = br & ~b_up & ~b_done & (dphi >= 0)
        b_grow = br & ~b_up & ~b_done & ~b_down
        # Zooming: shrink [lo, hi] around a sufficient decrease.
        z_hi = zm & (no_decrease | (f >= f_lo))
        z_done = zm & ~z_hi & curvature
        z_lo = zm & ~z_hi & ~z_done
        z_swap = z_lo & (dphi * (hi - lo) >= 0)

        done = b_done | z_done
        a_acc, f_acc, g_acc = (pick(done, a, a_acc), pick(done, f, f_acc),
                               pick(done, g, g_acc))
        to_hi = b_up | z_hi
        hi, f_hi = (torch.where(to_hi, a, torch.where(
            b_down, a_prev, torch.where(z_swap, lo, hi))),
            torch.where(to_hi, f, torch.where(
                b_down, f_prev, torch.where(z_swap, f_lo, f_hi))))
        to_lo = b_down | z_lo
        lo, f_lo, dphi_lo, g_lo = (
            torch.where(b_up, a_prev, torch.where(to_lo, a, lo)),
            torch.where(b_up, f_prev, torch.where(to_lo, f, f_lo)),
            torch.where(b_up, dphi_prev, torch.where(to_lo, dphi, dphi_lo)),
            pick(b_up, g_prev, pick(to_lo, g, g_lo)))
        a_prev = torch.where(b_grow, a, a_prev)
        f_prev = torch.where(b_grow, f, f_prev)
        dphi_prev = torch.where(b_grow, dphi, dphi_prev)
        g_prev = pick(b_grow, g, g_prev)
        a_cur = torch.where(b_grow, torch.clamp(2.0 * a, max=MAX_STEP),
                            a_cur)
        brackets = brackets + b_grow.to(brackets.dtype)
        phase = torch.where(done, 2, torch.where(b_up | b_down, 1, phase))

    # Out of evaluations: the low end of a zoom, or the last bracketing
    # step, if it decreased the objective.
    left = phase < 2
    zoom_ok = left & (phase == 1) & (lo > 0) & (f_lo < f0)
    grow_ok = left & (phase == 0) & (a_prev > 0) & (f_prev < f0)
    a_acc = torch.where(zoom_ok, lo, torch.where(grow_ok, a_prev, a_acc))
    f_acc = torch.where(zoom_ok, f_lo, torch.where(grow_ok, f_prev, f_acc))
    g_acc = pick(zoom_ok, g_lo, pick(grow_ok, g_prev, g_acc))
    ok = (phase == 2) | zoom_ok | grow_ok
    return a_acc, f_acc, g_acc, ok


def _lbfgs(fun, x0, max_iters, tol, vtol, memory_size, counter):
    """L-BFGS from every row of ``x0`` at once: ``(x, f, grad inf-norm,
    iterations)`` per row.

    A row stops on any of: gradient inf-norm below ``tol``; an iteration's
    improvement below ``vtol * (1 + |f|)`` (the objective's noise floor);
    ``max_iters``; a non-finite objective or gradient; a line search that
    found no step.
    """
    B, n = x0.shape
    x = x0.clone()
    f, g = fun(x)
    counter[0] += 1
    S = x.new_zeros(B, memory_size, n)
    Y = x.new_zeros(B, memory_size, n)
    rho = x.new_zeros(B, memory_size)
    nit = torch.zeros(B, dtype=torch.long, device=x.device)
    active = torch.isfinite(f) & torch.isfinite(g).all(dim=1)
    active &= g.abs().amax(dim=1) >= tol
    while bool(active.any()):
        d = _two_loop(g, S, Y, rho)
        dphi0 = torch.sum(g * d, dim=-1)
        # No descent (or no history yet): steepest descent, history reset.
        reset = ~(dphi0 < 0)
        d = torch.where(reset[:, None], -g, d)
        S = torch.where(reset[:, None, None], torch.zeros_like(S), S)
        Y = torch.where(reset[:, None, None], torch.zeros_like(Y), Y)
        rho = torch.where(reset[:, None], torch.zeros_like(rho), rho)
        fresh = rho[:, -1] == 0
        a0 = torch.where(fresh, torch.clamp(1.0 / torch.linalg.vector_norm(
            g, dim=1), max=1.0), torch.ones_like(f))
        a, f_new, g_new, ok = _line_search(fun, x, f, g, d, a0, active,
                                           counter)
        step = active & ok
        s = a[:, None] * d
        yv = g_new - g
        sy = torch.sum(s * yv, dim=-1)
        push = step & (sy > torch.finfo(x.dtype).eps *
                       torch.linalg.vector_norm(s, dim=1) *
                       torch.linalg.vector_norm(yv, dim=1))
        S = torch.where(push[:, None, None],
                        torch.cat([S[:, 1:], s[:, None]], dim=1), S)
        Y = torch.where(push[:, None, None],
                        torch.cat([Y[:, 1:], yv[:, None]], dim=1), Y)
        rho = torch.where(push[:, None], torch.cat(
            [rho[:, 1:], (1.0 / torch.where(push, sy, 1.0))[:, None]],
            dim=1), rho)
        stalled = (f - f_new) <= vtol * (1.0 + f_new.abs())
        x = torch.where(step[:, None], x + s, x)
        f = torch.where(step, f_new, f)
        g = torch.where(step[:, None], g_new, g)
        nit = nit + step.to(nit.dtype)
        err = g.abs().amax(dim=1)
        active = step & torch.isfinite(f) & torch.isfinite(err) & \
            (err >= tol) & ~stalled & (nit < max_iters)
    return x, f, g.abs().amax(dim=1), nit


def minimize(gp, y, x=None, yerr=None, log_prior=None, method="auto",
             restarts=0, generator=None, init_scale=1.0, max_iters=500,
             tol=None, vtol=None, memory_size=10, set_params=True,
             device=None, dtype=torch.float64):
    """Minimize the GP's negative marginal log-likelihood (or negative log
    posterior) over its active parameters.

    Drop-in for george's scipy flow::

        gp.compute(x, yerr)
        result = george_tpu_torch.optimize.minimize(gp, y)   # updates gp

    :param gp: a :class:`george_tpu_torch.GP`.  If it has been computed,
        its ``(x, yerr)`` are used; else pass them.
    :param y: observations.
    :param log_prior: optional ``log_prior(theta_active) -> scalar`` in
        torch operations, added to the objective (MAP instead of ML).  The
        parameter bounds always act as a barrier: out of bounds the
        objective is +inf, and the line search steps back.
    :param method: the likelihood's route, as in
        :func:`~george_tpu_torch.samplers.build_gp_log_prob` (``"auto"``:
        the O(N) state-space filter where the kernel admits it).
    :param restarts: the number of additional starts, ``theta0 +
        init_scale * N(0, I)``, all optimized in one batch.
    :param generator: the ``torch.Generator`` of the restarts (default: a
        CPU generator seeded with 0).
    :param tol: gradient inf-norm tolerance (default 1e-8 in float64, 1e-5
        in float32).
    :param vtol: relative improvement an iteration below which a restart
        has stalled (default 1e-12 in float64, 1e-7 in float32).
    :param set_params: write the winning vector back into ``gp``.
    :param device: where the objective runs (default: the CUDA card).
    :param dtype: the optimizer's floating type (default float64).
    :return: :class:`OptimizeResult`.
    """
    if x is None:
        if not hasattr(gp, "_x"):
            raise RuntimeError(
                "You need to compute the model first (or pass x=, yerr=)")
        x = gp._x
        yerr = np.sqrt(gp._yerr2)
    elif yerr is None:
        yerr = 0.0
    log_prob, theta0 = build_gp_log_prob(gp, x, y, yerr, log_prior=log_prior,
                                         method=method, device=device,
                                         dtype=dtype)
    f64 = dtype == torch.float64
    tol = (1e-8 if f64 else 1e-5) if tol is None else tol
    vtol = (1e-12 if f64 else 1e-7) if vtol is None else vtol

    starts = theta0[None]
    if restarts and restarts > 0:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        noise = init_scale * torch.randn(
            (restarts, theta0.shape[0]), generator=generator,
            dtype=torch.float64, device=generator.device)
        starts = torch.cat([starts, theta0[None] + noise.to(theta0)], dim=0)
    counter = [0]
    with torch.no_grad():
        xs, funs, gnorms, nits = _lbfgs(_objective(log_prob), starts,
                                        max_iters, tol, vtol, memory_size,
                                        counter)
    funs_host = funs.cpu().numpy().astype(np.float64)
    best = int(np.argmin(np.where(np.isnan(funs_host), np.inf, funs_host)))
    fun = float(funs_host[best])
    gnorm = float(gnorms[best])
    nit = int(nits[best])
    result = OptimizeResult(
        x=xs[best].cpu().numpy().astype(np.float64),
        fun=fun,
        grad_norm=gnorm,
        nit=nit,
        success=bool(np.isfinite(fun) and np.isfinite(gnorm)
                     and (gnorm < tol or nit < max_iters)),
        restart_funs=funs_host,
        restart_x0=starts.cpu().numpy().astype(np.float64),
        evaluations=counter[0],
    )
    if set_params and np.all(np.isfinite(result.x)):
        gp.set_parameter_vector(result.x)
    return result
