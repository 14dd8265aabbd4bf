# -*- coding: utf-8 -*-
"""Exact state-space (Kalman) GP likelihoods for 1-D Markovian kernels.

For one-dimensional inputs and the Markovian kernel families the GP is the
output of a linear time-invariant SDE, and the marginal likelihood is the
Kalman prediction-error decomposition: O(N) work.  Representable exactly
(state dimension in parens):

  * ``ExpKernel``      — Matern-1/2, Ornstein-Uhlenbeck (1)
  * ``Matern32Kernel``  (2)
  * ``Matern52Kernel``  (3)
  * ``CosineKernel``   — undamped oscillator, Q = 0 (2)
  * ``ConstantKernel`` — random offset, A = 1, Q = 0 (1)
  * sums of the above (block-diagonal state stacking), and products with
    constants (variance scaling)

Everything else raises :class:`StateSpaceUnsupported`.

The discrete-time system is exact for irregular sampling: per-gap
transitions ``A = expm(F dt)`` in closed form and process noise
``Q = Pinf - A Pinf A^T`` from stationarity.

Layout: the JAX package scalarizes the filter (every state entry a
chains-wide vector) because small stacked matrices pad to the TPU's
register tile.  Here the plain filter is batch-first PyTorch: the per-gap
systems of all steps are built at once, entrywise from the closed forms
(:func:`_build_system_entries`), and stacked into (steps, B, D, D) tensors;
the sequential recurrence is then a handful of batched small matmuls per
step.  The hand-written CUDA kernel (:mod:`george_tpu_torch.ops.kalman`)
runs the same recurrence with the whole state of a chain in registers.
"""

import math
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Tuple

import torch

from ..dsl.compiler import Leaf, node_size

__all__ = [
    "StateSpaceUnsupported", "Term", "extract_terms", "supports_state_space",
    "FAMILY_CODES", "kalman_loglike", "kalman_loglike_parallel",
    "kalman_filter", "rts_smoother_means", "sample_sequential",
    "filter_covariances", "affine_scan", "filter_means", "smoother_means",
    "sample_scan", "system_fn", "state_space_factor_fn",
    "state_space_apply_inverse_fn", "state_space_apply_sqrt_fn",
    "state_space_grad_core_fn", "state_space_loglike_fn", "COLUMN_CHUNK",
]


class StateSpaceUnsupported(ValueError):
    """Kernel tree has no exact finite-dimensional SDE representation."""


_MATERN_C = {0: 1.0, 1: math.sqrt(3.0), 2: math.sqrt(5.0)}
_MATERN_BY_NAME = {"ExpKernel": 0, "Matern32Kernel": 1, "Matern52Kernel": 2}
_DIMS = {"matern0": 1, "matern1": 2, "matern2": 3, "cosine": 2, "const": 1}

# Family ids shared with the CUDA kernel (csrc/kalman_vg.cu, KV_FAMS).
FAMILY_CODES = {"matern0": 0, "matern1": 1, "matern2": 2, "cosine": 3,
                "const": 4}


# -- term extraction from the kernel expression tree -------------------------

@dataclass(frozen=True)
class Term:
    """One Markovian block of the state.

    ``sigma2 = prod(naxes * exp(th[i]) for naxes, i in scales)`` (1 when
    ``scales`` is empty) and, from the kernel parameter ``th[rate]``, the
    family's rate: ``lam = c_p exp(-th/2)`` (materns), ``omega =
    2 pi / exp(th)`` (cosine); ``rate`` is -1 for a constant.  Indices are
    into the kernel's own parameter vector.  The explicit structure (rather
    than a closure) is what lets the CUDA kernel evaluate the same
    quantities.
    """

    family: str
    rate: int = -1
    scales: Tuple[Tuple[int, int], ...] = ()

    @property
    def dim(self):
        return _DIMS[self.family]

    def shifted(self, off):
        return Term(self.family, self.rate + off if self.rate >= 0 else -1,
                    tuple((n, i + off) for n, i in self.scales))

    def scaled(self, scales):
        return Term(self.family, self.rate, self.scales + tuple(scales))

    def sig_rate(self, th):
        """``th``: sequence of kernel-parameter (B,) tensors -> (sigma2,
        rate) as (B,) tensors."""
        like = th[self.rate] if self.rate >= 0 else th[self.scales[0][1]]
        sigma2 = torch.ones_like(like)
        for naxes, i in self.scales:
            sigma2 = sigma2 * (float(naxes) * torch.exp(th[i]))
        if self.family.startswith("matern"):
            c = _MATERN_C[int(self.family[-1])]
            return sigma2, c * torch.exp(-0.5 * th[self.rate])
        if self.family == "cosine":
            return sigma2, 2.0 * math.pi / torch.exp(th[self.rate])
        return sigma2, torch.zeros_like(like)


def _leaf_terms(leaf: Leaf):
    """One leaf -> (constant scales | None, [terms])."""
    if leaf.blocked:
        raise StateSpaceUnsupported("blocked kernels are not Markovian")
    if leaf.name == "EmptyKernel":
        return None, []
    if leaf.name == "ConstantKernel":
        return ((len(leaf.axes), 0),), []
    if leaf.name in _MATERN_BY_NAME:
        if len(leaf.axes) != 1:
            raise StateSpaceUnsupported("state-space path needs 1-D inputs")
        if leaf.metric_type not in (0, 1):
            raise StateSpaceUnsupported("general metrics are not separable")
        # r2 = tau^2 exp(-log_M): lam = c exp(-log_M / 2).
        p = _MATERN_BY_NAME[leaf.name]
        return None, [Term("matern%d" % p, rate=0)]
    if leaf.name == "CosineKernel":
        if len(leaf.axes) != 1:
            raise StateSpaceUnsupported("state-space path needs 1-D inputs")
        return None, [Term("cosine", rate=0)]
    raise StateSpaceUnsupported(
        "kernel '{0}' has no exact state-space form".format(leaf.name)
    )


def _tree_terms(node):
    """Recursive extraction: (constant scales | None, [terms])."""
    if isinstance(node, Leaf):
        return _leaf_terms(node)

    n1 = node_size(node.k1)
    c1, t1 = _tree_terms(node.k1)
    c2, t2 = _tree_terms(node.k2)
    t2 = [t.shifted(n1) for t in t2]
    if c2 is not None:
        c2 = tuple((n, i + n1) for n, i in c2)

    if node.op == "sum":
        # Constants become explicit random-offset terms when summed.
        terms = list(t1) + list(t2)
        for cf in (c1, c2):
            if cf is not None:
                terms.append(Term("const", scales=cf))
        return None, terms

    # product
    if t1 and t2:
        raise StateSpaceUnsupported(
            "product of two dynamic kernels has no closed state-space form"
        )
    if not t1 and not t2:        # const * const
        if c1 is None or c2 is None:
            return None, []
        return c1 + c2, []
    terms, scale = (t1, c2) if t1 else (t2, c1)
    if scale is None:            # product with Empty -> zero kernel
        return None, []
    return None, [t.scaled(scale) for t in terms]


def extract_terms(node):
    """Kernel tree -> list of :class:`Term` (or raise)."""
    cf, terms = _tree_terms(node)
    if cf is not None:
        terms = terms + [Term("const", scales=cf)]
    if not terms:
        raise StateSpaceUnsupported("empty kernel has no state")
    return terms


def supports_state_space(node):
    try:
        extract_terms(node)
        return True
    except StateSpaceUnsupported:
        return False


# -- per-term discrete-time systems (entrywise closed forms) -------------------
#
# Entries are tensors broadcastable against each other (per-chain (B,)
# parameters against (steps, 1) gaps); ``None`` marks a structural zero.

def _matern_entries(p, sigma2, lam, dt):
    """Entrywise (A, Pinf) for the Matern-(p+1/2) SDE.

    F = -lam I + N with N nilpotent (single Jordan block), so
    expm(F dt) = e^{-lam dt} sum_{k<=p} (N dt)^k / k! exactly.
    """
    if p == 0:
        return [[torch.exp(-lam * dt)]], [[sigma2]]
    if p == 1:
        lt = lam * dt
        e = torch.exp(-lt)
        A = [[e * (1.0 + lt), e * dt],
             [-e * lam * lam * dt, e * (1.0 - lt)]]
        Pinf = [[sigma2, None], [None, sigma2 * lam * lam]]
        return A, Pinf
    # p == 2: A = e^{-l dt} (I + N dt + N^2 dt^2 / 2), expanded entrywise.
    lt = lam * dt
    e = torch.exp(-lt)
    l2 = lam * lam
    A = [
        [e * (1.0 + lt + 0.5 * lt * lt), e * dt * (1.0 + lt),
         e * 0.5 * dt * dt],
        [e * (-0.5 * l2 * lam * dt * dt), e * (1.0 + lt - lt * lt),
         e * dt * (1.0 - 0.5 * lt)],
        [e * (l2 * lam * dt * (0.5 * lt - 1.0)), e * (l2 * dt * (lt - 3.0)),
         e * (1.0 - 2.0 * lt + 0.5 * lt * lt)],
    ]
    kappa = l2 / 3.0
    Pinf = [[sigma2, None, -sigma2 * kappa],
            [None, sigma2 * kappa, None],
            [-sigma2 * kappa, None, sigma2 * l2 * l2]]
    return A, Pinf


def _cosine_entries(sigma2, omega, dt):
    wt = omega * dt
    c, s = torch.cos(wt), torch.sin(wt)
    return [[c, -s], [s, c]], [[sigma2, None], [None, sigma2]]


def _const_entries(sigma2, dt):
    return [[1.0 + 0.0 * dt]], [[sigma2]]


def _family_entries(family, sigma2, rate, dt):
    if family.startswith("matern"):
        return _matern_entries(int(family[-1]), sigma2, rate, dt)
    if family == "cosine":
        return _cosine_entries(sigma2, rate, dt)
    return _const_entries(sigma2, dt)


def _q_entries(A, Pinf, d):
    """Entrywise Q = Pinf - A Pinf A^T (None-aware, symmetric)."""
    Q = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            acc = None
            for k in range(d):
                if A[i][k] is None:
                    continue
                for l in range(d):
                    if Pinf[k][l] is None or A[j][l] is None:
                        continue
                    term = A[i][k] * Pinf[k][l] * A[j][l]
                    acc = term if acc is None else acc + term
            pij = Pinf[i][j]
            if pij is None:
                Q[i][j] = None if acc is None else -acc
            else:
                Q[i][j] = pij if acc is None else pij - acc
            Q[j][i] = Q[i][j]
    return Q


def _build_system_entries(terms, sig_rates, dt):
    """Entrywise block-diagonal (Phi [D][D], Q [D][D], Pinf [D][D])."""
    D = sum(t.dim for t in terms)
    Phi = [[None] * D for _ in range(D)]
    Q = [[None] * D for _ in range(D)]
    Pinf = [[None] * D for _ in range(D)]
    off = 0
    for t, (sigma2, rate) in zip(terms, sig_rates):
        d = t.dim
        A_b, P_b = _family_entries(t.family, sigma2, rate, dt)
        Q_b = _q_entries(A_b, P_b, d)
        for i in range(d):
            for j in range(d):
                Phi[off + i][off + j] = A_b[i][j]
                Q[off + i][off + j] = Q_b[i][j]
                Pinf[off + i][off + j] = P_b[i][j]
        off += d
    return Phi, Q, Pinf


def _stack_entries(E, shape, like):
    """Nested-list entries (None = 0) -> a stacked (*shape, d, d) tensor."""
    z = like.new_zeros(shape)
    rows = [
        torch.stack([z if e is None else torch.broadcast_to(e + z, shape)
                     for e in row], dim=-1)
        for row in E
    ]
    return torch.stack(rows, dim=-2)


# -- the batch-first sequential filter ------------------------------------------

class _FilterMachine:
    """Batched filter building blocks for a fixed term list.

    State: means ``m`` (B, D) and covariances ``P`` (B, D, D); ``h`` selects
    the observed coordinate of every block (the first one).
    """

    def __init__(self, terms, like):
        self.terms = terms
        self.D = sum(t.dim for t in terms)
        self.obs = []
        off = 0
        for t in terms:
            self.obs.append(off)
            off += t.dim
        self.h = like.new_zeros(self.D)
        self.h[self.obs] = 1.0
        self.eye = torch.eye(self.D, dtype=like.dtype, device=like.device)

    def sig_rates(self, th_kernel):
        """Per-term (sigma2, rate); ``th_kernel`` (B, P) tensor."""
        cols = [th_kernel[:, i] for i in range(th_kernel.shape[1])]
        return [t.sig_rate(cols) for t in self.terms]

    def systems(self, sig_rates, dt):
        """(Phi, Q) for every gap, (steps, B, D, D), and Pinf (B, D, D)."""
        like = sig_rates[0][0]
        B = like.shape[0]
        Phi_e, Q_e, Pinf_e = _build_system_entries(
            self.terms, sig_rates, dt[:, None]
        )
        shape = (dt.shape[0], B)
        Phi = _stack_entries(Phi_e, shape, like)
        Q = _stack_entries(Q_e, shape, like)
        _, _, Pinf_e = _build_system_entries(
            self.terms, sig_rates, like.new_zeros(())
        )
        return Phi, Q, _stack_entries(Pinf_e, (B,), like)

    def gain_update(self, m_, P_, y_k, v_k):
        """Observe ``y_k`` with variance ``v_k``: ``(m, P, K, innov, S)``."""
        # Joseph-form update keeps P PSD in float32.
        h = self.h
        Ph = P_ @ h                                  # (B, D)
        S = Ph @ h + v_k
        innov = y_k - m_ @ h
        K = Ph / S[:, None]
        m = m_ + K * innov[:, None]
        Bm = self.eye - K[:, :, None] * h[None, None, :]
        P = Bm @ P_ @ Bm.transpose(-1, -2) \
            + v_k[:, None, None] * K[:, :, None] * K[:, None, :]
        return m, P, K, innov, S

    def obs_update(self, m_, P_, y_k, v_k, acc):
        m, P, _, innov, S = self.gain_update(m_, P_, y_k, v_k)
        acc = acc - 0.5 * (torch.log(2.0 * math.pi * S) + innov * innov / S)
        return m, P, acc

    @staticmethod
    def predict(m, P, Phi_k, Q_k):
        mp = (Phi_k @ m[:, :, None])[:, :, 0]
        Pp = Phi_k @ P @ Phi_k.transpose(-1, -2) + Q_k
        return mp, Pp


def kalman_loglike(terms, th_kernel, dt, r, v):
    """Prediction-error log-likelihood per chain.

    :param th_kernel: (B, P) kernel parameters.
    :param dt: (N-1,) gaps of the sorted inputs.
    :param r, v: (B, N) or (N,) residuals and observation variances.
    :returns: (B,) log-likelihoods (differentiable by autograd).
    """
    fm = _FilterMachine(terms, th_kernel)
    B = th_kernel.shape[0]
    n = dt.shape[0] + 1
    r = torch.broadcast_to(r, (B, n))
    v = torch.broadcast_to(v, (B, n))
    sig_rates = fm.sig_rates(th_kernel)
    Phi, Q, Pinf = fm.systems(sig_rates, dt)
    m = th_kernel.new_zeros(B, fm.D)
    acc = th_kernel.new_zeros(B)
    # Step 0 observes the stationary prior directly.
    m, P, acc = fm.obs_update(m, Pinf, r[:, 0], v[:, 0], acc)
    for k in range(n - 1):
        m, P = fm.predict(m, P, Phi[k], Q[k])
        m, P, acc = fm.obs_update(m, P, r[:, k + 1], v[:, k + 1], acc)
    return acc


# -- the associative-scan filter ----------------------------------------------

def _small_inv(M):
    """Inverse of (..., d, d): the adjugate for d <= 3, else LU."""
    d = M.shape[-1]
    if d == 1:
        return 1.0 / M
    if d == 2:
        a, b = M[..., 0, 0], M[..., 0, 1]
        c, e = M[..., 1, 0], M[..., 1, 1]
        det = a * e - b * c
        inv = torch.stack([torch.stack([e, -b], dim=-1),
                           torch.stack([-c, a], dim=-1)], dim=-2)
        return inv / det[..., None, None]
    if d == 3:
        m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        m10, m11, m12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
        m20, m21, m22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
        c00 = m11 * m22 - m12 * m21
        c01 = m12 * m20 - m10 * m22
        c02 = m10 * m21 - m11 * m20
        c10 = m02 * m21 - m01 * m22
        c11 = m00 * m22 - m02 * m20
        c12 = m01 * m20 - m00 * m21
        c20 = m01 * m12 - m02 * m11
        c21 = m02 * m10 - m00 * m12
        c22 = m00 * m11 - m01 * m10
        det = m00 * c00 + m01 * c01 + m02 * c02
        inv = torch.stack([torch.stack([c00, c10, c20], dim=-1),
                           torch.stack([c01, c11, c21], dim=-1),
                           torch.stack([c02, c12, c22], dim=-1)], dim=-2)
        return inv / det[..., None, None]
    return torch.linalg.inv(M)


def _solve_small(M, R):
    """solve(M, R) through :func:`_small_inv` for tiny trailing dims."""
    if M.shape[-1] <= 3:
        return _small_inv(M) @ R
    return torch.linalg.solve(M, R)


def combine(ei, ej):
    """The filtering operator of Särkkä & García-Fernández (2021).

    ``e = (A, b, C, eta, J)`` with leading batch dims; ``ei`` comes first in
    time.  ``e_i * e_j = (Aj W Ai, Aj W (bi + Ci etaj) + bj, Aj W Ci Aj^T +
    Cj, Ai^T Wt (etaj - Jj bi) + etai, Ai^T Wt Jj Ai + Ji)`` with ``W = (I +
    Ci Jj)^-1`` and ``Wt = (I + Jj Ci)^-1``.
    """
    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    d = Ai.shape[-1]
    eye = torch.eye(d, dtype=Ai.dtype, device=Ai.device)
    G = _solve_small(eye + Ci @ Jj, torch.cat(
        [Ai, Ci, (bi + (Ci @ etaj[..., None])[..., 0])[..., None]], dim=-1))
    WA, WC, Wb = G[..., :d], G[..., d:2 * d], G[..., -1]
    AjT = Aj.transpose(-1, -2)
    A_n = Aj @ WA
    b_n = (Aj @ Wb[..., None])[..., 0] + bj
    C_n = Aj @ WC @ AjT + Cj
    Gt = _solve_small(eye + Jj @ Ci, torch.cat(
        [Jj @ Ai, (etaj - (Jj @ bi[..., None])[..., 0])[..., None]], dim=-1))
    AiT = Ai.transpose(-1, -2)
    J_n = AiT @ Gt[..., :-1] + Ji
    eta_n = (AiT @ Gt[..., -1][..., None])[..., 0] + etai
    return A_n, b_n, C_n, eta_n, J_n


def associative_scan(fn, elems):
    """Inclusive scan of ``fn`` over the leading axis of every tensor of
    ``elems`` in O(log n) depth (the odd/even recursion of
    ``jax.lax.associative_scan``)."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = associative_scan(fn, fn(tuple(e[0:-1:2] for e in elems),
                                  tuple(e[1::2] for e in elems)))
    if n % 2 == 0:
        even = fn(tuple(o[:-1] for o in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    out = []
    for e, ev, o in zip(elems, even, odd):
        ev = torch.cat([e[:1], ev], dim=0)
        pairs = torch.stack([ev[:o.shape[0]], o], dim=1).flatten(0, 1)
        out.append(torch.cat([pairs, ev[o.shape[0]:]], dim=0))
    return tuple(out)


def filter_elements(fm, Phi, Q, Pinf, r, v):
    """The per-observation elements of the associative-scan filter.

    ``Phi``, ``Q``: (N-1, B, D, D); ``Pinf``: (B, D, D); ``r``, ``v``:
    (N, B).  Element k >= 1 conditions on the state at k - 1; element 0 is
    the filtered posterior of observation 0 from the stationary prior.
    Returns ``(A, b, C, eta, J)`` with leading dims (N, B).
    """
    h, eye = fm.h, fm.eye
    Qh = Q @ h                                          # (M, B, D)
    S = Qh @ h + v[1:]
    K = Qh / S[..., None]
    ikh = eye - K[..., :, None] * h
    PhiTH = Phi.transpose(-1, -2) @ h
    A = ikh @ Phi
    b = K * r[1:, :, None]
    C = ikh @ Q
    eta = PhiTH * (r[1:] / S)[..., None]
    J = PhiTH[..., :, None] * PhiTH[..., None, :] / S[..., None, None]

    Ph0 = Pinf @ h                                      # (B, D)
    S0 = Ph0 @ h + v[0]
    K0 = Ph0 / S0[:, None]
    ikh0 = eye - K0[:, :, None] * h
    C0 = ikh0 @ Pinf @ ikh0.transpose(-1, -2) \
        + v[0][:, None, None] * K0[:, :, None] * K0[:, None, :]
    head = (torch.zeros_like(Pinf), K0 * r[0][:, None], C0,
            torch.zeros_like(Ph0), torch.zeros_like(Pinf))
    return tuple(torch.cat([h0[None], e], dim=0)
                 for h0, e in zip(head, (A, b, C, eta, J)))


def kalman_loglike_parallel(terms, th_kernel, dt, r, v):
    """The prediction-error log-likelihood per chain by the associative-scan
    filter: O(log N) depth of batched (D, D) operations.

    Same arguments and result as :func:`kalman_loglike`.  The prefix of the
    elements at k is the filtered state of observation k; the innovations
    are then evaluated at once from the one-step-shifted filtered states.
    """
    fm = _FilterMachine(terms, th_kernel)
    B = th_kernel.shape[0]
    n = dt.shape[0] + 1
    D = fm.D
    r = torch.broadcast_to(r, (B, n)).transpose(0, 1)
    v = torch.broadcast_to(v, (B, n)).transpose(0, 1)
    Phi, Q, Pinf = fm.systems(fm.sig_rates(th_kernel), dt)
    _, bs, Cs, _, _ = associative_scan(
        combine, filter_elements(fm, Phi, Q, Pinf, r, v))
    # Filtered state at k - 1 -> innovation at k; the k = 0 row predicts
    # from the prior (m = 0, P = 0, Q = Pinf).
    m_prev = torch.cat([bs.new_zeros(1, B, D), bs[:-1]], dim=0)
    P_prev = torch.cat([Cs.new_zeros(1, B, D, D), Cs[:-1]], dim=0)
    Phi_all = torch.cat([fm.eye.expand(1, B, D, D), Phi], dim=0)
    Q_all = torch.cat([Pinf[None], Q], dim=0)
    m_pred = (Phi_all @ m_prev[..., None])[..., 0]
    P_pred = Phi_all @ P_prev @ Phi_all.transpose(-1, -2) + Q_all
    S = (P_pred @ fm.h) @ fm.h + v
    innov = r - m_pred @ fm.h
    return torch.sum(-0.5 * (torch.log(2.0 * math.pi * S) + innov * innov / S),
                     dim=0)


# -- one GP's solver: covariances once, columns of data by affine scans -------
#
# The JAX package's solver functions run the filter and the smoother as
# loops of N steps, once a column of data.  On the card a loop of N steps
# is ~20 small launches a step.  Here the quantities that do not depend on
# the data (innovation variances S_k, gains K_k, filtered and predicted
# covariances, smoother gains G_k) come once a (theta, t, v) from the
# associative-scan filter at zero data, at O(log N) depth, and every
# column-dependent quantity is an affine recurrence m_k = A_k m_{k-1} + b_k,
# batched over the columns and run as an associative scan of (D x D, D)
# maps:
#
#   * filtered means:  m_k = (I - K_k h^T) Phi_k m_{k-1} + K_k y_k;
#   * smoothed means, backward:  m^s_k = G_k m^s_{k+1} + (m^f_k - G_k m^p_{k+1});
#   * draws:  m_k = Phi_k m_{k-1} + K_k sqrt(S_k) z_k, y_k = h^T Phi_k m_{k-1}
#     + sqrt(S_k) z_k.
#
# :func:`kalman_filter`, :func:`rts_smoother_means` and
# :func:`sample_sequential` follow the JAX package's loops step by step; they
# are the tests' plain models, and nothing on the card's path calls them.

# Columns of data a scan takes at once.  A scan's intermediates are a few
# (N, D, columns) tensors: at N = 100,000, D = 3 and 256 columns each is
# ~0.6 GB in float64.
COLUMN_CHUNK = 256


def _system(terms, th_kernel, dt):
    """``(Phi (N-1, D, D), Q (N-1, D, D), Pinf (D, D), h (D,))`` of one
    kernel parameter vector ``th_kernel`` (P,) over the gaps ``dt``."""
    fm = _FilterMachine(terms, th_kernel[None])
    Phi, Q, Pinf = fm.systems(fm.sig_rates(th_kernel[None]), dt)
    return Phi[:, 0], Q[:, 0], Pinf[0], fm.h


def system_fn(node):
    """``build(th_kernel, t) -> (Phi, Q, Pinf, h)`` for a kernel tree and
    sorted 1-D inputs ``t``."""
    terms = extract_terms(node)

    def build(th_kernel, t):
        return _system(terms, th_kernel, torch.diff(t))

    return build


def _with_prior_step(Phi):
    """``Phi_all`` (N, D, D): an identity transition before step 0."""
    eye = torch.eye(Phi.shape[-1], dtype=Phi.dtype, device=Phi.device)
    return torch.cat([eye[None], Phi], dim=0)


def _h_dot(h, m):
    """``h^T m_k`` for means ``m`` (N, D, C): (N, C)."""
    return torch.einsum("d,ndc->nc", h, m)


def kalman_filter(Phi, Q, Pinf, h, y, v):
    """The sequential Kalman filter (a plain model: the JAX package's loop,
    step by step, Joseph-form update).

    ``y`` is (N,) or (N, C), columns that share the covariances.  Returns
    ``(S (N,), innov, m_f, P_f (N, D, D), m_p, P_p)``: the innovation
    variances and values, and the filtered and predicted moments of every
    step; ``innov`` is (N[, C]), the means (N, D[, C]).
    """
    single = y.dim() == 1
    Y = y[:, None] if single else y
    D = Pinf.shape[0]
    eye = torch.eye(D, dtype=Y.dtype, device=Y.device)
    Phi_all = _with_prior_step(Phi)
    Q_all = torch.cat([torch.zeros_like(Pinf)[None], Q], dim=0)
    m, P = Y.new_zeros(D, Y.shape[1]), Pinf
    steps = []
    for k in range(Y.shape[0]):
        m_ = Phi_all[k] @ m
        P_ = Phi_all[k] @ P @ Phi_all[k].T + Q_all[k]
        Ph = P_ @ h
        S = h @ Ph + v[k]
        innov = Y[k] - h @ m_
        K = Ph / S
        m = m_ + K[:, None] * innov[None]
        ikh = eye - torch.outer(K, h)
        P = ikh @ P_ @ ikh.T + v[k] * torch.outer(K, K)
        steps.append((S, innov, m, P, m_, P_))
    S, innov, m_f, P_f, m_p, P_p = (torch.stack(z) for z in zip(*steps))
    if single:
        innov, m_f, m_p = innov[:, 0], m_f[..., 0], m_p[..., 0]
    return S, innov, m_f, P_f, m_p, P_p


def rts_smoother_means(Phi, Q, Pinf, h, y, v):
    """Smoothed state means E[x_k | y] by the sequential Rauch-Tung-Striebel
    pass (a plain model): (N, D) for ``y`` (N,), (N, D, C) for (N, C)."""
    _, _, m_f, P_f, m_p, P_p = kalman_filter(Phi, Q, Pinf, h, y, v)
    m_s = [m_f[-1]]
    for k in range(m_f.shape[0] - 2, -1, -1):
        G = P_f[k] @ Phi[k].T @ _small_inv(P_p[k + 1])
        m_s.append(m_f[k] + G @ (m_s[-1] - m_p[k + 1]))
    return torch.stack(m_s[::-1])


def sample_sequential(Phi, Q, Pinf, h, Z, v):
    """Draws with covariance K + diag(v) from iid normals ``Z`` (N,) or
    (C, N) by the innovations square root, the JAX package's loop step by
    step (a plain model): ``y_k = h^T m^-_k + sqrt(S_k) z_k``, the filter
    updated on the drawn value."""
    single = Z.dim() == 1
    Zc = (Z[None] if single else Z).T
    D = Pinf.shape[0]
    eye = torch.eye(D, dtype=Zc.dtype, device=Zc.device)
    Phi_all = _with_prior_step(Phi)
    Q_all = torch.cat([torch.zeros_like(Pinf)[None], Q], dim=0)
    m, P = Zc.new_zeros(D, Zc.shape[1]), Pinf
    ys = []
    for k in range(Zc.shape[0]):
        m_ = Phi_all[k] @ m
        P_ = Phi_all[k] @ P @ Phi_all[k].T + Q_all[k]
        Ph = P_ @ h
        S = h @ Ph + v[k]
        y_k = h @ m_ + torch.sqrt(S) * Zc[k]
        K = Ph / S
        m = m_ + K[:, None] * (y_k - h @ m_)[None]
        ikh = eye - torch.outer(K, h)
        P = ikh @ P_ @ ikh.T + v[k] * torch.outer(K, K)
        ys.append(y_k)
    out = torch.stack(ys).T
    return out[0] if single else out


def filter_covariances(Phi, Q, Pinf, h, v):
    """The data-free part of the filter by the associative-scan filter at
    zero data (O(log N) depth): ``(S (N,), K (N, D), P_f (N, D, D), P_p (N,
    D, D))``, the innovation variances, gains, and filtered and predicted
    covariances."""
    # The fields of _FilterMachine that filter_elements reads.
    gains = SimpleNamespace(h=h, eye=torch.eye(h.shape[0], dtype=h.dtype,
                                               device=h.device))
    zero = v.new_zeros(v.shape[0], 1)
    _, _, P_f, _, _ = associative_scan(combine, filter_elements(
        gains, Phi[:, None], Q[:, None], Pinf[None], zero, v[:, None]))
    P_f = P_f[:, 0]
    P_p = torch.cat([Pinf[None], Phi @ P_f[:-1] @ Phi.transpose(-1, -2) + Q],
                    dim=0)
    Ph = P_p @ h
    S = Ph @ h + v
    return S, Ph / S[:, None], P_f, P_p


def _affine_combine(ei, ej):
    Ai, bi = ei
    Aj, bj = ej
    return Aj @ Ai, Aj @ bi + bj


def affine_scan(A, b):
    """``m_k = A_k m_{k-1} + b_k`` for k = 0..N-1 from m_{-1} = 0, by an
    associative scan of the affine maps (O(log N) depth).  ``A`` (N, D, D)
    is shared by the columns of ``b`` (N, D, C); returns m (N, D, C)."""
    return associative_scan(_affine_combine, (A, b))[1]


def filter_means(Phi, h, K, Y):
    """Filtered and predicted means and the innovations of columns ``Y``
    (N, C), given the gains ``K``: ``(m_f (N, D, C), m_p (N, D, C), innov
    (N, C))``."""
    Phi_all = _with_prior_step(Phi)
    eye = Phi_all[0]
    m_f = affine_scan((eye - K[:, :, None] * h) @ Phi_all,
                      K[:, :, None] * Y[:, None, :])
    m_p = Phi_all @ torch.cat([torch.zeros_like(m_f[:1]), m_f[:-1]], dim=0)
    return m_f, m_p, Y - _h_dot(h, m_p)


def smoother_gains(Phi, P_f, P_p):
    """``G_k = P_f,k Phi_k^T P_p,k+1^-1`` for k < N - 1: (N-1, D, D)."""
    return P_f[:-1] @ Phi.transpose(-1, -2) @ _small_inv(P_p[1:])


def smoother_means(G, m_f, m_p):
    """Smoothed means (N, D, C): ``m^s_k = G_k m^s_{k+1} + (m^f_k - G_k
    m^p_{k+1})`` from m^s_{N-1} = m^f_{N-1}, an affine scan over the
    reversed steps."""
    D = m_f.shape[1]
    A = torch.cat([m_f.new_zeros(1, D, D), G.flip(0)], dim=0)
    b = torch.cat([m_f[-1:], (m_f[:-1] - G @ m_p[1:]).flip(0)], dim=0)
    return affine_scan(A, b).flip(0)


def sample_scan(Phi, h, S, K, Zc):
    """Draws (N, C) with covariance K + diag(v) from iid normals ``Zc``
    (N, C) by the innovations square root, as an affine scan."""
    Phi_all = _with_prior_step(Phi)
    e = torch.sqrt(S)[:, None] * Zc
    m = affine_scan(Phi_all, K[:, :, None] * e[:, None, :])
    m_prev = torch.cat([torch.zeros_like(m[:1]), m[:-1]], dim=0)
    return _h_dot(h, Phi_all @ m_prev) + e


def _by_columns(fn, Y, chunk):
    """``fn`` over the columns of ``Y`` (N,) or (N, C), ``chunk`` at a
    time."""
    single = Y.dim() == 1
    Yc = Y[:, None] if single else Y
    parts = [fn(Yc[:, i:i + chunk]) for i in range(0, Yc.shape[1], chunk)]
    out = torch.cat(parts, dim=1) if parts else fn(Yc)
    return out[:, 0] if single else out


class StateSpaceFactor:
    """One GP's filter quantities that do not depend on the data, computed
    once a (theta, t, v) by :func:`filter_covariances`: the solver's
    "factorization".  Columns of data then take affine scans only,
    :data:`COLUMN_CHUNK` columns at a time."""

    def __init__(self, terms, th_kernel, dt, v, chunk=COLUMN_CHUNK):
        self.Phi, _, _, self.h = sys = _system(terms, th_kernel, dt)
        self.v = v
        self.S, self.K, P_f, P_p = filter_covariances(*sys, v)
        self.G = smoother_gains(self.Phi, P_f, P_p)
        self.chunk = chunk

    @property
    def log_determinant(self):
        """log det(K + diag(v)) = sum log S_k."""
        return torch.sum(torch.log(self.S))

    def dot_solve(self, Y):
        """``y^T (K + diag(v))^-1 y`` = sum innov^2 / S, per column."""
        def cols(Yc):
            innov = filter_means(self.Phi, self.h, self.K, Yc)[2]
            return torch.sum(innov * innov / self.S[:, None], dim=0)[None]
        return _by_columns(cols, Y, self.chunk)[0]

    def apply_inverse(self, Y):
        """``(K + diag(v))^-1 Y`` by the regression identity ``(y - h^T
        m^s) / v`` (requires v > 0)."""
        def cols(Yc):
            m_f, m_p, _ = filter_means(self.Phi, self.h, self.K, Yc)
            m_s = smoother_means(self.G, m_f, m_p)
            return (Yc - _h_dot(self.h, m_s)) / self.v[:, None]
        return _by_columns(cols, Y, self.chunk)

    def apply_sqrt(self, Z):
        """Draws with covariance K + diag(v) from iid normals ``Z`` (N,) or
        (C, N), in the same layout."""
        if Z.dim() == 1:
            return self.apply_sqrt(Z[None])[0]
        return _by_columns(lambda Zc: sample_scan(self.Phi, self.h, self.S,
                                                  self.K, Zc),
                           Z.T, self.chunk).T


def state_space_factor_fn(node):
    """``factor(th_kernel, t, v) -> (logdet, (Phi, Q, Pinf, h))``: the
    log-determinant of K + diag(v) from the innovation variances."""
    build = system_fn(node)

    def factor(th_kernel, t, v):
        sys = build(th_kernel, t)
        return torch.sum(torch.log(filter_covariances(*sys, v)[0])), sys

    return factor


def state_space_apply_inverse_fn(node):
    """``apply_inv(th_kernel, t, v, Y) -> (K + diag(v))^-1 Y`` for ``Y``
    (N,) or (N, C), through the smoother (requires v > 0)."""
    terms = extract_terms(node)

    def apply_inv(th_kernel, t, v, Y):
        return StateSpaceFactor(terms, th_kernel, torch.diff(t),
                                v).apply_inverse(Y)

    return apply_inv


def state_space_apply_sqrt_fn(node):
    """``apply_sqrt(th_kernel, t, v, Z) -> draws`` with covariance
    K + diag(v) from iid normals ``Z`` (N,) or (C, N): the innovations
    representation K + diag(v) = L S L^T (L unit lower triangular in time
    order) is the Cholesky factorization the filter computes implicitly."""
    terms = extract_terms(node)

    def apply_sqrt(th_kernel, t, v, Z):
        return StateSpaceFactor(terms, th_kernel, torch.diff(t),
                                v).apply_sqrt(Z)

    return apply_sqrt


def state_space_grad_core_fn(node):
    """``core(theta, wn_vec, t, r, yerr2) -> (g_theta, g_wn_vec, alpha)``,
    everything in sorted order: the gradient of the log-likelihood with
    respect to the kernel parameters and the per-point log white noise by
    autograd through the associative-scan filter, and ``alpha = K^-1 r``
    from the smoother.  (The GP takes the Kalman kernel instead where the
    white noise is one scalar: ``GP.grad_log_likelihood``.)"""
    terms = extract_terms(node)

    def core(theta, wn_vec, t, r, yerr2):
        dt = torch.diff(t)
        with torch.enable_grad():
            th = theta.detach().clone().requires_grad_(True)
            wn = wn_vec.detach().clone().requires_grad_(True)
            ll = kalman_loglike_parallel(terms, th[None], dt, r,
                                         yerr2 + torch.exp(wn))[0]
            g_theta, g_wn = torch.autograd.grad(ll, (th, wn))
        with torch.no_grad():
            alpha = StateSpaceFactor(terms, theta, dt, yerr2 + torch.exp(
                wn_vec)).apply_inverse(r)
        return g_theta, g_wn, alpha

    return core


def state_space_loglike_fn(node, method="parallel"):
    """``ll(th_kernel, t, r, v) -> scalar`` for a kernel tree, ``t`` sorted,
    ``r`` the residuals, ``v`` the observation variances.

    ``method``: ``"parallel"`` the associative-scan filter;
    ``"sequential"`` (or ``"sequential_stacked"``) the batch-first
    sequential filter.  An empty tree gives the diagonal likelihood.
    """
    if method not in ("parallel", "sequential", "sequential_stacked"):
        raise ValueError("unknown method '{0}'".format(method))
    if _tree_terms(node) == (None, []):
        def ll_empty(th_kernel, t, r, v):
            return torch.sum(-0.5 * (torch.log(2.0 * math.pi * v) + r * r / v))
        return ll_empty
    terms = extract_terms(node)
    fn = kalman_loglike_parallel if method == "parallel" else kalman_loglike

    def ll(th_kernel, t, r, v):
        return fn(terms, th_kernel[None], torch.diff(t), r, v)[0]

    return ll
