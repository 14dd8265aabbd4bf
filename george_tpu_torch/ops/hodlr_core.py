# -*- coding: utf-8 -*-
"""Level-batched HODLR factorization in PyTorch.

The port of ``george_tpu/ops/hodlr_core.py``, at its names and with its
algorithm: the binary tree over the padded index range is implicit (level
q has 2^q nodes of size n_pad / 2^(q+1) on each side), each level's
off-diagonal blocks are compressed by batched partial-pivot ACA (adaptive
cross approximation) in masked lockstep iterations, and the factorization
is multiplicative, K = D_leaf F_(L-1) ... F_0 with each F_q^-1 a rank-2r
Woodbury update, log det K the leaf Cholesky log-determinants plus those
of the 2r x 2r coupling matrices S_q.

Every per-node and per-chain quantity rides a batch axis: a tensor is
(batch, nodes, ...), where the batch holds the sampler's chains.  Nothing
here syncs with the host but the stats of :func:`hodlr_compute` (one copy
of the log-determinant, the saturation flag and the pivot counts an
attempt) and those of :func:`record_pivots`.

Two ACA forms:

* the adaptive one (:func:`_aca_fn`), sequential in the rank: each step
  evaluates a residual row and column of the kernel, the next pivot by
  ``argmax`` on the device (the first maximum, as the JAX package's);
* the replay (:func:`_aca_fixed_fn`) of recorded pivots, with the JAX
  package's Tikhonov-damped reciprocal or, for the GP API's gradient, the
  plain one.  With the pivots known, every row and column of a level is
  one batched kernel evaluation; the elimination runs on the r x r matrix
  of pivot entries alone (one small rank-1 update a step, all levels at
  once), and the full factors follow by two triangular solves.  In exact
  arithmetic it equals the sequential replay; an adaptive run's factors
  equal the plain replay of its own pivots, which is how the GP API's
  gradient is taken.

Gradients go through the replay by reverse mode, one backward pass for
every parameter and every chain.  The JAX package takes forward mode, one
``jvp`` a parameter, because reverse mode through its sequential replay
checkpoints (m, rank) carries at every step; the replay here has no such
loop (its only sequential part is the r-step elimination on r x r
matrices), so the backward pass keeps O(N r) a level, and it avoids
``torch.autograd.forward_ad``'s host cost: every operation that meets a
plain tensor or a Python scalar there takes 0.15-0.6 ms of host time
(~90 ms a value+gradient at N = 2048, against 15 ms of device time, on an
H100).  The float32 products run in true FP32 (:func:`fp32_matmuls`): the
Woodbury subtractions amplify TF32's rounding into the likelihood.  The
blocks are far below ``config.pallas_min_elements`` and the ACA evaluates
single rows and columns, so no evaluation here takes the covariance
kernel: the batched evaluator is plain PyTorch.
"""

import contextlib
import math
import warnings
from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch
from scipy.linalg import LinAlgError

from ..dsl import compiler
from ..dsl.specs import available_kernels

__all__ = ["HODLRFactorization", "hodlr_compute", "hodlr_solve",
           "hodlr_dot_solve", "hodlr_grad_fn", "hodlr_grad_core",
           "plan_tree", "adaptive_pivots", "record_pivots",
           "fp32_matmuls"]


@contextlib.contextmanager
def fp32_matmuls():
    """Float32 products in true FP32 (no TF32) inside, the caller's
    setting restored after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


@dataclass
class HODLRFactorization:
    """Device-side state of a computed HODLR factorization (batch of 1)."""

    n: int                     # true problem size
    n_pad: int                 # padded (power-of-two leaf multiple) size
    levels: int                # number of internal levels L
    leaf_size: int
    leaf_chol: torch.Tensor    # (n_leaf, m, m) lower Cholesky factors
    level_U0: List[torch.Tensor] = field(default_factory=list)
    level_V0: List[torch.Tensor] = field(default_factory=list)
    level_Ut: List[torch.Tensor] = field(default_factory=list)
    level_Vt: List[torch.Tensor] = field(default_factory=list)
    level_S_lu: List[Tuple] = field(default_factory=list)
    log_determinant: float = 0.0
    ranks: Tuple[int, ...] = ()   # the rank caps the factorization ran at
    ranks_used: Tuple[int, ...] = ()  # per level, the most steps a node took
    pivots: Tuple = ()            # per level (rows, cols, pmag, nk)
    factors: object = None        # the batched form the solves run on


def plan_tree(n, min_size):
    """Choose tree depth and padding: leaves satisfy size < 2 * min_size."""
    levels = 0
    while (n >> levels) >= 2 * max(1, min_size) and (n >> levels) > 2:
        levels += 1
    n_leaf = 1 << levels
    leaf_size = -(-n // n_leaf)  # ceil
    return levels, n_leaf * leaf_size, leaf_size


def _rank_cap(tol, m):
    """Static ACA rank cap from the tolerance (reference caps at full rank)."""
    if tol <= 0:
        return m
    cap = 16 + int(round(-8.0 * math.log10(max(tol, 1e-14))))
    return int(min(m, max(8, cap)))


# ---------------------------------------------------------------------------
# Batched kernel evaluation.
# ---------------------------------------------------------------------------

def _param_rows(p):
    """(B, k) parameters -> (k, B, 1, 1, 1): ``rows[i]`` broadcasts over a
    (B, nodes, m1, m2) grid."""
    return p.T.reshape(p.shape[1], p.shape[0], 1, 1, 1)


def _pairwise(A1, A2):
    """(..., m1, k), (..., m2, k) -> (..., m1, m2) squared distances from
    exact differences."""
    if A1.shape[-1] == 1:
        d = A1[..., :, None, 0] - A2[..., None, :, 0]
        return d * d
    d = A1[..., :, None, :] - A2[..., None, :, :]
    return torch.sum(d * d, dim=-1)


def _unpack_cholesky(mp, n):
    """(B, n(n+1)/2) packed row-major lower triangles -> (B, n, n) with the
    diagonal exponentiated (``dsl/compiler._unpack_cholesky``, batched)."""
    i, j = torch.tril_indices(n, n)
    scatter = torch.zeros(len(i), n * n, dtype=mp.dtype, device=mp.device)
    scatter[torch.arange(len(i)), i * n + j] = 1.0
    L = (mp @ scatter).reshape(-1, n, n)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return L - torch.diag_embed(d) + torch.diag_embed(torch.exp(d))


@lru_cache(maxsize=None)
def _batched_value_builder(node):
    """``f(theta (B, P), X1 (b, nodes, m1, d), X2 (b, nodes, m2, d)) ->
    (B, nodes, m1, m2)`` with b in {1, B}: the compiler's plain evaluator
    with the chains and the nodes on leading axes (same formulas)."""
    if isinstance(node, compiler.Op):
        f1 = _batched_value_builder(node.k1)
        f2 = _batched_value_builder(node.k2)
        n1 = compiler.node_size(node.k1)
        if node.op == "sum":
            return lambda th, X1, X2: (f1(th[:, :n1], X1, X2)
                                       + f2(th[:, n1:], X1, X2))
        return lambda th, X1, X2: (f1(th[:, :n1], X1, X2)
                                   * f2(th[:, n1:], X1, X2))

    spec = available_kernels()[node.name]
    consts = dict(node.constants)
    axes = list(node.axes)
    npar = node.nparams

    def full(out, X1, X2, B):
        shape = (B,) + X1.shape[1:-2] + (X1.shape[-2], X2.shape[-2])
        return out.expand(shape) if out.shape != shape else out

    def block_mask(out, X1, X2):
        m1 = compiler._block_mask(X1.reshape(-1, X1.shape[-1]), node.axes,
                                  node.min_block, node.max_block)
        m2 = compiler._block_mask(X2.reshape(-1, X2.shape[-1]), node.axes,
                                  node.min_block, node.max_block)
        m1 = m1.reshape(X1.shape[:-1])
        m2 = m2.reshape(X2.shape[:-1])
        return torch.where(m1[..., :, None] & m2[..., None, :], out,
                           0.0)

    if node.stationary:
        value = compiler._compile_scalar_fn(spec, consts, ("r2",), spec.value)
        slope = compiler._compile_scalar_fn(spec, consts, ("r2",),
                                            spec.grad_dict["r2"])
        k = len(axes)
        every_axis = axes == list(range(node.ndim))

        def ev(theta, X1, X2):
            B = theta.shape[0]
            p, mp = theta[:, :npar], theta[:, npar:]
            if every_axis and X1.shape[-1] == len(axes):
                A1, A2 = X1, X2
            else:
                A1, A2 = X1[..., axes], X2[..., axes]
            if node.metric_type == 0:
                r2 = _pairwise(A1, A2) * torch.exp(-mp[:, 0]).reshape(
                    B, 1, 1, 1)
            elif node.metric_type == 1:
                scale = torch.exp(-0.5 * mp).reshape(B, 1, 1, k)
                r2 = _pairwise(A1 * scale, A2 * scale)
            elif node.metric_type == 2:
                L = _unpack_cholesky(mp, k)[:, None]
                B1 = torch.linalg.solve_triangular(L, A1.mT, upper=False).mT
                B2 = torch.linalg.solve_triangular(L, A2.mT, upper=False).mT
                r2 = _pairwise(B1, B2)
            else:
                raise ValueError("unknown metric_type {0}".format(
                    node.metric_type))
            rows = _param_rows(p)
            # The value at a constant r2 (autograd through sqrt(r2) is NaN
            # at r2 = 0); r2's gradient enters through the DSL's
            # closed-form slope, as in the compiler's radial functions.
            r2c = r2.detach()
            out = value(rows, r2c)
            if r2.requires_grad:
                out = out + slope(rows.detach(), r2c) * (r2 - r2c)
            out = full(out, X1, X2, B)
            return block_mask(out, X1, X2) if node.blocked else out

        return ev

    pair = compiler._pair_fn(node.name, node.constants)

    def ev(theta, X1, X2):
        B = theta.shape[0]
        rows = _param_rows(theta)
        total = X1.new_zeros(())
        for j in axes:
            total = total + pair(rows, X1[..., :, j, None], X2[..., None, :, j])
        return full(total, X1, X2, B)

    return ev


# ---------------------------------------------------------------------------
# The factorization's pieces (the JAX package's names).
# ---------------------------------------------------------------------------

def _leaf_factor_fn(node):
    """Batched leaf build + Cholesky: masked kernel blocks with unit
    diagonal padding so that K_pad = [[K, 0], [0, I]] exactly.  A leaf that
    is not positive definite makes its chain's log-determinant NaN."""
    ev = _batched_value_builder(node)

    def factor(theta, xb, diagb, validb):
        # xb (n_leaf, m, d); diagb (B, n_leaf, m); validb (n_leaf, m) bool
        K = ev(theta, xb[None], xb[None])
        K = torch.where(validb[:, :, None] & validb[:, None, :], K, 0.0)
        K = K + torch.diag_embed(torch.where(validb, diagb, 1.0))
        L, info = torch.linalg.cholesky_ex(K)
        logdet = 2.0 * torch.sum(
            torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=(-2, -1))
        failed = torch.any(info != 0, dim=-1)
        logdet = torch.where(failed, torch.full_like(logdet, np.nan), logdet)
        return L, logdet

    return factor


def _gather_points(X, idx):
    """Points of X (nodes, m, d) at per-node indices idx (b, nodes, k) ->
    (b, nodes, k, d)."""
    node = torch.arange(X.shape[0], device=X.device)[None, :, None]
    return X[node, idx]


def _aca_fn(node, rank):
    """Batched partial-pivot ACA of off-diagonal blocks B = k(Xl, Xr).

    Runs ``rank`` lockstep iterations per node; once a node's running
    Frobenius estimate says it converged (|u||v| <= tol * |B_approx|_F), its
    remaining columns are written as zeros.  Pivot rows follow the classic
    max-|residual-column| rule seeded by the largest entry of the first
    valid column.  Not differentiated: the gradient replays the pivots.
    """
    ev = _batched_value_builder(node)

    def aca(theta, Xl, Xr, ml, mr, tol):
        B = theta.shape[0]
        nq, m, _ = Xl.shape
        dt = theta.dtype
        dev = theta.device
        U = torch.zeros((B, nq, m, rank), dtype=dt, device=dev)
        V = torch.zeros((B, nq, m, rank), dtype=dt, device=dev)
        rows = torch.zeros((B, nq, rank), dtype=torch.long, device=dev)
        cols = torch.zeros((B, nq, rank), dtype=torch.long, device=dev)
        pmag = torch.zeros((B, nq, rank), dtype=dt, device=dev)
        used = (~ml).expand(B, nq, m).clone()  # padded rows never pivots
        mlf, mrf = ml.to(dt), mr.to(dt)
        neg_inf = torch.tensor(-np.inf, dtype=dt, device=dev)
        # Seed the first pivot row from the largest entry of the first valid
        # column (an arbitrary row risks a pivot many orders of magnitude
        # below the block scale).
        first = torch.argmax(mr.to(torch.uint8), dim=-1)
        x0 = _gather_points(Xr, first[None, :, None])
        col0 = ev(theta, Xl[None], x0)[..., 0]
        col0 = torch.where(ml, torch.abs(col0), neg_inf)
        i_cur = torch.argmax(col0, dim=-1)
        norm2 = torch.zeros((B, nq), dtype=dt, device=dev)
        scale = torch.clamp(torch.amax(col0, dim=-1), min=0.0)
        done = torch.zeros((B, nq), dtype=torch.bool, device=dev)
        nk = torch.zeros((B, nq), dtype=torch.long, device=dev)
        tol2 = tol * tol
        for k in range(rank):
            # Residual row i_cur of B - U V^T.
            xi = _gather_points(Xl, i_cur[..., None])
            row = ev(theta, xi, Xr[None])[..., 0, :]
            Ui = torch.take_along_dim(U, i_cur[..., None, None], dim=2)
            row = row * mrf - (Ui @ V.mT)[..., 0, :]
            j = torch.argmax(torch.abs(row), dim=-1)
            pivot = torch.take_along_dim(row, j[..., None], dim=-1)[..., 0]
            apiv = torch.abs(pivot)
            # Once the residual reaches the noise floor of the eliminations
            # so far, pivots are cancellation noise: treat that as converged.
            ok = (apiv > 1e-14 * scale) & (apiv > 1e-300) & ~done
            # Residual column j.
            xj = _gather_points(Xr, j[..., None])
            col = ev(theta, Xl[None], xj)[..., 0]
            Vj = torch.take_along_dim(V, j[..., None, None], dim=2)
            col = col * mlf - (U @ Vj.mT)[..., 0]
            safe = torch.where(ok, pivot, 1.0)
            u = torch.where(ok[..., None], col / safe[..., None], 0.0)
            v = torch.where(ok[..., None], row, 0.0)
            # Frobenius-norm running estimate (cross terms over the columns
            # written so far, zero beyond k).
            cross = torch.sum((U.mT @ u[..., None])[..., 0]
                              * (V.mT @ v[..., None])[..., 0], dim=-1)
            term = torch.sum(u * u, dim=-1) * torch.sum(v * v, dim=-1)
            norm2 = norm2 + 2.0 * cross + term
            scale = torch.maximum(scale, apiv)
            done = done | (term <= tol2 * norm2) | ~ok
            U[..., k] = u
            V[..., k] = v
            rows[..., k] = i_cur
            cols[..., k] = j
            pmag[..., k] = apiv
            nk = nk + ok.long()
            used.scatter_(-1, i_cur[..., None], True)
            scores = torch.where(used, neg_inf, torch.abs(u))
            i_cur = torch.argmax(scores, dim=-1)
        # Not converged within the rank cap: the block's numerical rank
        # exceeds the budget.
        return U, V, ~done, rows, cols, pmag, nk

    return aca


def _aca_fixed_fn(node, rank, damped=True):
    """ACA replaying RECORDED pivots (no argmax, no tolerance): the pivot
    rows and columns of each level in one batched evaluation each, so that
    the approximation is a smooth deterministic function of theta.

    Returns ``pieces(theta, Xl, Xr, ml, mr, rows, cols, pmag, nk) -> (R, C,
    W, on, dd)``: the pivot rows R (B, nodes, r, m) and columns C (B,
    nodes, m, r) of the masked block, the pivot entries W[k, l] = R[k,
    cols[l]], the step mask ``on`` (k < nk) and the damping ``dd`` (None
    for the plain reciprocal).  :func:`_replay_factors` eliminates them.

    ``damped``: the reciprocal pivot / (pivot^2 + delta^2 + 1e-20) with
    delta = 1e-3 x the recorded pivot magnitude (the sampler route: ~1 /
    pivot while the pivot is healthy, rolling the column off continuously
    as it degenerates, so the density stays smooth in theta); otherwise
    the plain 1 / pivot of the adaptive run that recorded them.
    """
    ev = _batched_value_builder(node)

    def pieces(theta, Xl, Xr, ml, mr, rows, cols, pmag, nk):
        dt = theta.dtype
        rows, cols = rows[..., :rank], cols[..., :rank]
        R = ev(theta, _gather_points(Xl, rows), Xr[None]) \
            * mr.to(dt)[:, None, :]
        C = ev(theta, Xl[None], _gather_points(Xr, cols)) \
            * ml.to(dt)[:, :, None]
        W = torch.take_along_dim(R, cols[..., None, :], dim=-1)
        steps = torch.arange(rank, device=theta.device)
        on = (steps < nk[..., None]).to(dt)
        dd = None
        if damped:
            delta = 1e-3 * pmag[..., :rank].to(dt)
            dd = delta * delta
        return R, C, W, on, dd

    return pieces


def _eliminate(W, on, dd):
    """The replayed elimination on the pivot entries alone.

    W (X, r, r); on, dd (X, r) (dd None: the plain reciprocal).  Step k
    takes the residual's row and column k, scales the column by a_k (the
    damped or plain reciprocal of the pivot W[k, k], zero where the step
    is off) and subtracts the rank-1 product.  Returns U_I = [a_k col_k]
    and V_J = [row_k] (X, r, r), the factors' rows at the pivot rows and
    the pivot columns (an off step's row multiplies a zero column of U
    wherever it is used), and the steps' scales a (X, r).
    """
    us, vs, scales = [], [], []
    if dd is not None:
        # An off step's infinite denominator makes its scale exactly 0.
        dd = torch.where(on > 0, dd + 1e-20, np.inf)
    for k in range(W.shape[-1]):
        col = W[:, :, k]
        row = W[:, k, :]
        p = W[:, k, k]
        if dd is None:
            on_k = on[:, k]
            a = on_k / torch.where(on_k > 0, p, 1.0)
        else:
            a = p / torch.addcmul(dd[:, k], p, p)
        u = a[:, None] * col
        scales.append(a)
        us.append(u)
        vs.append(row)
        W = torch.baddbmm(W, u[:, :, None], row[:, None, :], alpha=-1.0)
    return (torch.stack(us, dim=-1), torch.stack(vs, dim=-1),
            torch.stack(scales, dim=-1))


def _replay_factors(R, C, U_I, V_J, on, a_diag):
    """The full factors of one level from its pivot rows and columns and
    the eliminated pivot entries: V^T = (I + D_on tril(U_I))^-1 D_on R and
    U = C D_a (I + M)^-1 with M[l, k] = a_k V_J[k, l] (l < k), the
    sequential replay's recurrences as unit triangular solves."""
    Vt = torch.linalg.solve_triangular(
        on[..., :, None] * torch.tril(U_I, diagonal=-1), on[..., :, None] * R,
        upper=False, unitriangular=True)
    M = (a_diag[..., :, None] * torch.tril(V_J, diagonal=-1)).mT
    U = torch.linalg.solve_triangular(M, C * a_diag[..., None, :],
                                      upper=True, left=False,
                                      unitriangular=True)
    return U, Vt.mT


def _leaf_solve(leaf_chol, y):
    """Apply blockdiag(leaf)^-1 to a (B, n_pad, k) matrix."""
    B, n_leaf, m, _ = leaf_chol.shape
    yb = y.reshape(B, n_leaf, m, -1)
    z = torch.linalg.solve_triangular(leaf_chol, yb, upper=False)
    z = torch.linalg.solve_triangular(leaf_chol.mT, z, upper=True)
    return z.reshape(y.shape)


def _level_couplings(F0, Z, nq, r):
    """S_q = [[I, U^T Ut], [V^T Vt, I]] per node, its LU, and log|det|.

    ``F0`` / ``Z`` are a level's factors in full height (B, n_pad, r):
    U (resp. Ut) on the left children's rows, V (resp. Vt) on the right's.
    """
    B = F0.shape[0]
    m = F0.shape[1] // (2 * nq)
    AB = F0.reshape(B, nq, 2, m, r).mT @ Z.reshape(B, nq, 2, m, r)
    eye = torch.eye(r, dtype=F0.dtype, device=F0.device).expand(B, nq, r, r)
    S = torch.cat([torch.cat([eye, AB[:, :, 0]], dim=-1),
                   torch.cat([AB[:, :, 1], eye], dim=-1)], dim=-2)
    lu, piv, _ = torch.linalg.lu_factor_ex(S)
    logdet = torch.sum(torch.log(torch.abs(
        torch.diagonal(lu, dim1=-2, dim2=-1))), dim=(-2, -1))
    return (lu, piv), logdet


def _apply_level_inverse(F0, Z, S_lu, nq, r, y):
    """Apply F_q^-1 = I - X S^-1 Y^T to a (B, n_pad, k) matrix: with
    Y^T z = [U^T z_top; V^T z_bot] and X w = (Ut w2; Vt w1) per node."""
    B, n_pad, k = y.shape
    m = n_pad // (2 * nq)
    lu, piv = S_lu
    yb = y.reshape(B, nq, 2, m, k)
    w = (F0.reshape(B, nq, 2, m, r).mT @ yb).reshape(B, nq, 2 * r, k)
    s = torch.linalg.lu_solve(lu, piv, w)
    s = s.reshape(B, nq, 2, r, k).flip(2)       # [s2, s1]
    return (yb - Z.reshape(B, nq, 2, m, r) @ s).reshape(B, n_pad, k)


@dataclass
class _Factors:
    """A batched factorization: the leaf factors, every level's ACA factors
    (F0) and transformed factors (Z) side by side in full height, level q
    in columns offs[q]:offs[q + 1], the couplings' LUs and log det."""

    leaf_chol: torch.Tensor
    F0: torch.Tensor
    Z: torch.Tensor
    ranks: Tuple[int, ...]
    offs: Tuple[int, ...]
    S_lu: list
    logdet: torch.Tensor

    def level(self, q, which):
        return which[..., self.offs[q]:self.offs[q + 1]]


def _to_full(U, V):
    """Left-child factors U and right-child factors V (B, nodes, m, r) ->
    one (B, n_pad, r) matrix."""
    B, nq, m, r = U.shape
    return torch.stack([U, V], dim=2).reshape(B, nq * 2 * m, r)


def _sweep(leaf_chol, leaf_logdet, UV, n_pad):
    """The transform sweep: the leaf inverse on every level's factors, then
    deepest to shallowest each level's couplings and its inverse applied to
    the shallower levels' factors (all of them in one call)."""
    levels = len(UV)
    ranks = tuple(int(U.shape[-1]) for U, _ in UV)
    offs = tuple(int(v) for v in np.concatenate([[0], np.cumsum(ranks)]))
    if UV:
        F0 = torch.cat([_to_full(U, V) for U, V in UV], dim=-1)
    else:
        F0 = leaf_chol.new_zeros((leaf_chol.shape[0], n_pad, 0))
    Z = _leaf_solve(leaf_chol, F0)
    S_lus = [None] * levels
    logdet = leaf_logdet
    for q in range(levels - 1, -1, -1):
        nq, r = 1 << q, ranks[q]
        F0q = F0[..., offs[q]:offs[q + 1]]
        Zq = Z[..., offs[q]:offs[q + 1]]
        S_lus[q], ld = _level_couplings(F0q, Zq, nq, r)
        logdet = logdet + ld
        if q:
            low = _apply_level_inverse(F0q, Zq, S_lus[q], nq, r,
                                       Z[..., :offs[q]])
            Z = torch.cat([low, Z[..., offs[q]:]], dim=-1)
    return _Factors(leaf_chol, F0, Z, ranks, offs, S_lus, logdet)


def _solve_all(f, z):
    """blockdiag(leaf)^-1 then every level's F_q^-1 on (B, n_pad, k)."""
    z = _leaf_solve(f.leaf_chol, z)
    for q in range(len(f.ranks) - 1, -1, -1):
        z = _apply_level_inverse(f.level(q, f.F0), f.level(q, f.Z),
                                 f.S_lu[q], 1 << q, f.ranks[q], z)
    return z


def _level_blocks(x_pad, valid, q):
    """Level q's left and right point blocks (nodes, m, d) and masks."""
    n_pad, d = x_pad.shape
    m = n_pad >> (q + 1)
    shaped = x_pad.reshape(1 << q, 2, m, d)
    vq = valid.reshape(1 << q, 2, m)
    return shaped[:, 0], shaped[:, 1], vq[:, 0], vq[:, 1]


def _compute_all_fn(node, levels, leaf_size, ranks, pivot_mode="adaptive"):
    """The whole factorization over a batch of parameter vectors.

    ``compute(theta (B, P), x_pad (n_pad, d), diag_pad (B, n_pad), valid
    (n_pad,), tol, pivots=None)``; ``pivot_mode``:

      * ``"adaptive"`` (default) -- partial-pivot ACA, tolerance-driven;
        returns ``(factors, saturated (B,))``;
      * ``"record"`` -- adaptive, and the returned tuple gains a trailing
        ``pivots`` tuple (per level: rows, cols, pmag, nk);
      * ``"fixed"`` -- replays ``pivots`` with the damped reciprocal (the
        sampler route); ``"replay"`` -- with the plain one (the GP API's
        gradient: an adaptive run's own pivots give its factors).  Both
        return the factors alone, differentiable in theta and the
        diagonal.
    """
    leaf_factor = _leaf_factor_fn(node)
    fixed = pivot_mode in ("fixed", "replay")
    if fixed:
        fns = [_aca_fixed_fn(node, r, damped=pivot_mode == "fixed")
               for r in ranks]
    else:
        fns = [_aca_fn(node, r) for r in ranks]

    def compute(theta, x_pad, diag_pad, valid, tol, pivots=None):
        n_pad, d = x_pad.shape
        B = theta.shape[0]
        n_leaf = 1 << levels
        xb = x_pad.reshape(n_leaf, leaf_size, d)
        db = diag_pad.reshape(B, n_leaf, leaf_size)
        vb = valid.reshape(n_leaf, leaf_size)
        leaf_chol, leaf_logdet = leaf_factor(theta, xb, db, vb)
        if fixed:
            UV = _replay_levels(fns, theta, x_pad, valid, pivots)
        else:
            UV, saturated, out_pivots = [], None, []
            for q in range(levels):
                U, V, sat, rows, cols, pmag, nk = fns[q](
                    theta, *_level_blocks(x_pad, valid, q), tol)
                sat = torch.any(sat, dim=-1)
                saturated = sat if saturated is None else saturated | sat
                out_pivots.append((rows, cols, pmag, nk))
                UV.append((U, V))
            if saturated is None:
                saturated = torch.zeros(B, dtype=torch.bool,
                                        device=theta.device)
        f = _sweep(leaf_chol, leaf_logdet, UV, n_pad)
        if fixed:
            return f
        if pivot_mode == "record":
            return f, saturated, tuple(out_pivots)
        return f, saturated

    return compute


def _replay_levels(fns, theta, x_pad, valid, pivots):
    """Every level's replayed factors; the eliminations of all levels run
    as one batch (padded to the largest rank with steps switched off)."""
    if not fns:
        return []
    B = theta.shape[0]
    parts = []
    for q, fn in enumerate(fns):
        Xl, Xr, ml, mr = _level_blocks(x_pad, valid, q)
        parts.append(fn(theta, Xl, Xr, ml, mr, *pivots[q]))
    damped = parts[0][4] is not None
    rmax = max(W.shape[-1] for _, _, W, _, _ in parts)
    Ws, ons, dds, sizes = [], [], [], []
    for R, C, W, on, dd in parts:
        r = W.shape[-1]
        nq = W.shape[1]
        pad = rmax - r
        Ws.append(torch.nn.functional.pad(W, (0, pad, 0, pad))
                  .reshape(B * nq, rmax, rmax))
        ons.append(torch.nn.functional.pad(on.expand(B, nq, r), (0, pad))
                   .reshape(B * nq, rmax))
        if damped:
            dds.append(torch.nn.functional.pad(dd.expand(B, nq, r), (0, pad),
                                               value=1.0)
                       .reshape(B * nq, rmax))
        sizes.append(B * nq)
    U_I, V_J, scales = _eliminate(torch.cat(Ws), torch.cat(ons),
                          torch.cat(dds) if damped else None)
    out, start = [], 0
    for (R, C, W, on, dd), size in zip(parts, sizes):
        r = W.shape[-1]
        nq = W.shape[1]
        sl = slice(start, start + size)
        start += size
        ui = U_I[sl, :r, :r].reshape(B, nq, r, r)
        vj = V_J[sl, :r, :r].reshape(B, nq, r, r)
        a_diag = scales[sl, :r].reshape(B, nq, r)
        out.append(_replay_factors(R, C, ui, vj, on.expand(B, nq, r), a_diag))
    return out



def _pad_points(x, n_pad):
    pad = n_pad - x.shape[0]
    return torch.cat([x, x[-1:].expand(pad, x.shape[1])])


def _pad_vector(v, n_pad, value):
    pad = n_pad - v.shape[-1]
    return torch.cat([v, v.new_full(v.shape[:-1] + (pad,), value)], dim=-1)


def _ranks_used(pivots):
    """Per level, the most steps any node took (at least 1): the columns
    beyond are zero and drop out of the factorization exactly."""
    if not pivots:
        return torch.zeros(0, dtype=torch.long)
    return torch.stack([torch.clamp(nk.amax(), min=1)
                        for _, _, _, nk in pivots])


def adaptive_pivots(node, theta, x_pad, valid, levels, ranks, tol):
    """The adaptive ACA's pivots of every level for a batch of parameter
    vectors, on the device (no sweep, no sync): per level (rows, cols,
    pmag, nk) of batch B, and the saturation flags (B,)."""
    pivots, saturated = [], torch.zeros(theta.shape[0], dtype=torch.bool,
                                        device=theta.device)
    with fp32_matmuls():
        for q in range(levels):
            _, _, sat, rows, cols, pmag, nk = _aca_fn(node, ranks[q])(
                theta, *_level_blocks(x_pad, valid, q), tol)
            saturated = saturated | torch.any(sat, dim=-1)
            pivots.append((rows, cols, pmag, nk))
    return tuple(pivots), saturated


def record_pivots(node, theta, x_pad, valid, levels, ranks, tol):
    """The adaptive ACA's pivots at one parameter vector: ``(pivots,
    saturated, ranks_used)`` with ``pivots`` per level of batch 1,
    ``saturated`` a host bool and ``ranks_used`` the host tuple of
    :func:`_ranks_used` (one sync)."""
    pivots, saturated = adaptive_pivots(node, theta.reshape(1, -1), x_pad,
                                        valid, levels, ranks, tol)
    stats = torch.cat([saturated.long().cpu(),
                       _ranks_used(pivots).cpu()]).numpy()
    return pivots, bool(stats[0]), tuple(int(r) for r in stats[1:])


def _fact_from(f, n, levels, leaf_size, ranks, pivots, logdet):
    """A :class:`HODLRFactorization` over batch 0 of ``f``."""
    U0s, V0s, Uts, Vts = [], [], [], []
    n_pad = f.F0.shape[1]
    for q in range(levels):
        nq, r = 1 << q, f.ranks[q]
        m = n_pad // (2 * nq)
        F0q = f.level(q, f.F0)[0].reshape(nq, 2, m, r)
        Zq = f.level(q, f.Z)[0].reshape(nq, 2, m, r)
        U0s.append(F0q[:, 0])
        V0s.append(F0q[:, 1])
        Uts.append(Zq[:, 0])
        Vts.append(Zq[:, 1])
    return HODLRFactorization(
        n=n, n_pad=n_pad, levels=levels, leaf_size=leaf_size,
        leaf_chol=f.leaf_chol[0], level_U0=U0s, level_V0=V0s,
        level_Ut=Uts, level_Vt=Vts,
        level_S_lu=[(lu[0], piv[0]) for lu, piv in f.S_lu],
        log_determinant=logdet, ranks=tuple(ranks), pivots=pivots,
        factors=f)


def hodlr_compute(node, theta, x, diag_noise, min_size=100, tol=0.1,
                  seed=42, max_rank=None, device=None, dtype=torch.float64):
    """Compute the HODLR factorization of K(x, x) + diag(diag_noise).

    ``node`` is the kernel's static expression tree, ``theta`` its full
    parameter vector; ``device`` / ``dtype`` those of the factorization.
    ``seed`` is accepted for API parity with the reference (its randomized
    row sampling); the batched ACA here is deterministic.  The ranks
    escalate (doubling, up to three times) while a block saturates its cap,
    unless ``max_rank`` fixes them; a saturated result warns, a failed one
    raises ``LinAlgError``.  One host sync an attempt.
    """
    del seed
    x = torch.as_tensor(np.asarray(x, dtype=np.float64), device=device) \
        .to(dtype)
    if x.dim() == 1:
        x = x[:, None]
    theta = torch.as_tensor(np.asarray(theta, dtype=np.float64),
                            device=x.device).to(dtype).reshape(1, -1)
    diag = torch.as_tensor(np.array(diag_noise, dtype=np.float64),
                           device=x.device).to(dtype)
    n = x.shape[0]
    levels, n_pad, leaf_size = plan_tree(n, min_size)
    x_pad = _pad_points(x, n_pad)
    diag_pad = _pad_vector(diag, n_pad, 1.0)[None]
    valid = torch.arange(n_pad, device=x.device) < n

    full = tuple(n_pad >> (q + 1) for q in range(levels))
    caps = [min(full[q], max_rank) if max_rank else _rank_cap(tol, full[q])
            for q in range(levels)]
    # The reference's sequential ACA grows each block's rank until the
    # tolerance is met; with static ranks, saturation retries with doubled
    # caps.  An explicit max_rank is a hard cap: only warn.
    with fp32_matmuls():
        for _attempt in range(4):
            ranks = tuple(min(full[q], caps[q]) for q in range(levels))
            f, sat, pivots = _compute_all_fn(
                node, levels, leaf_size, ranks, pivot_mode="record")(
                theta, x_pad, diag_pad, valid, tol)
            stats = torch.cat([
                torch.stack([f.logdet[0], sat[0].to(dtype)]),
                _ranks_used(pivots).to(f.logdet)]).cpu().numpy()  # one sync
            if stats[1] == 0.0 or ranks == full or max_rank:
                break
            caps = [c * 2 for c in caps]

    logdet = float(stats[0])
    if stats[1] != 0.0:
        if max_rank:
            warnings.warn(
                "HODLR off-diagonal blocks did not reach tol={0} within "
                "the explicit max_rank={1}; results are approximate.  "
                "Raise max_rank (or loosen tol) for a tighter "
                "factorization.".format(tol, max_rank))
        else:
            warnings.warn(
                "HODLR off-diagonal blocks did not reach tol={0} within "
                "rank caps {1} (after automatic escalation); results are "
                "approximate.  Loosen tol or sort the inputs "
                "(nd_sort_samples) for better compression.".format(
                    tol, ranks))
    if not np.isfinite(logdet):
        raise LinAlgError("HODLR factorization failed (not PD?)")
    fact = _fact_from(f, n, levels, leaf_size, ranks, pivots, logdet)
    fact.ranks_used = tuple(int(v) for v in stats[2:])
    return fact


def _as_columns(fact, y):
    """(n,) or (n, k) array or tensor -> zero-padded (1, n_pad, k) on the
    factorization's device and dtype, and whether it was a vector."""
    like = fact.leaf_chol
    y = torch.as_tensor(y, device=like.device).to(like.dtype) \
        if torch.is_tensor(y) else \
        torch.as_tensor(np.asarray(y, dtype=np.float64),
                        device=like.device).to(like.dtype)
    single = y.dim() == 1
    if single:
        y = y[:, None]
    pad = fact.n_pad - fact.n
    z = torch.cat([y, y.new_zeros((pad, y.shape[1]))])
    return z[None], single


def hodlr_solve(fact, y):
    """Apply K^-1 to a (n,) vector or (n, k) matrix; a tensor on the
    factorization's device."""
    z, single = _as_columns(fact, y)
    with fp32_matmuls():
        out = _solve_all(fact.factors, z)[0, :fact.n]
    return out[:, 0] if single else out


def hodlr_dot_solve(fact, y):
    """``y^T K^-1 y`` fused with the solve; a device scalar."""
    z, _ = _as_columns(fact, y)
    with fp32_matmuls():
        return torch.sum(z * _solve_all(fact.factors, z))


def hodlr_loglike(compute, theta, x_pad, r_pad, diag_pad, valid, tol,
                  pivots):
    """``(-0.5 (log det K + r^T K^-1 r) (B,), K^-1 r (B, n_pad))`` for a
    batch of kernel parameters, residuals and diagonals over a
    ``_compute_all_fn`` in a replay mode (differentiable)."""
    f = compute(theta, x_pad, diag_pad, valid, tol, pivots)
    alpha = _solve_all(f, r_pad.expand(theta.shape[0], -1)[..., None])[..., 0]
    return -0.5 * (f.logdet + torch.sum(r_pad * alpha, dim=-1)), alpha


def hodlr_grad_fn(node, levels, leaf_size, ranks):
    """Factorization-aware gradient core at a fixed plan, never an N x N
    matrix: ``core(theta (P,), wn_dirs (n_dirs, n_pad), wn_pad, x_pad,
    r_pad, yerr2_pad, valid, tol, pivots) -> (g_theta (P,), g_wn_proj
    (n_dirs,), alpha (n_pad,))`` differentiating ``-0.5 (logdet + r^T K^-1
    r)`` with ``K = k(theta) + diag(yerr2 + exp(wn))``; ``g_wn_proj[j]`` is
    the derivative along ``wn_dirs[j]``.  The factorization replays
    ``pivots`` (an adaptive run's) with the plain reciprocal, which
    reproduces that run's factors and differentiates the adaptive map where
    its pivots are locally constant; one backward pass gives every
    direction."""
    compute = _compute_all_fn(node, levels, leaf_size, ranks,
                              pivot_mode="replay")

    def core(theta, wn_dirs, wn_pad, x_pad, r_pad, yerr2_pad, valid, tol,
             pivots):
        with fp32_matmuls(), torch.enable_grad():
            theta = theta.detach().requires_grad_(True)
            wn = wn_pad.detach().requires_grad_(True)
            diag = torch.where(valid, yerr2_pad + torch.exp(wn), 1.0)
            ll, alpha = hodlr_loglike(compute, theta[None], x_pad, r_pad,
                                      diag[None], valid, tol, pivots)
            g_theta, g_wn = torch.autograd.grad(ll[0], (theta, wn))
        return g_theta, wn_dirs @ g_wn, alpha.detach()[0]

    return core


def hodlr_grad_core(node, fact, theta, wn_vec, x_sorted, r_sorted,
                    yerr2_sorted, tol, wn_dirs=None, theta_idx=None):
    """Gradient of the HODLR marginal likelihood in the solver's sorted
    order at the plan and pivots of ``fact``: ``(g_theta (P,), g_wn_proj
    (n_wn_dirs,), alpha (n,))`` as tensors (:func:`hodlr_grad_fn`).

    ``wn_dirs`` holds the white-noise model's derivative rows (d wn_i / d
    theta_j); the white-noise gradient comes back projected onto them.
    ``theta_idx`` (default all) are the kernel parameters reported; the
    others read zero.
    """
    like = fact.leaf_chol
    dt, dev = like.dtype, like.device

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float64),
                               device=dev).to(dt)

    n, n_pad = fact.n, fact.n_pad
    theta = t(theta)
    theta_idx = tuple(range(len(theta))) if theta_idx is None \
        else tuple(int(i) for i in theta_idx)
    dirs = like.new_zeros((0, n_pad)) if wn_dirs is None else \
        _pad_vector(t(np.atleast_2d(wn_dirs)), n_pad, 0.0)
    core = hodlr_grad_fn(node, fact.levels, fact.leaf_size, fact.ranks_used)
    g_theta, g_wn_proj, alpha = core(
        theta, dirs, _pad_vector(t(wn_vec), n_pad, 0.0),
        _pad_points(t(np.atleast_2d(x_sorted).reshape(n, -1)), n_pad),
        _pad_vector(t(r_sorted), n_pad, 0.0),
        _pad_vector(t(yerr2_sorted), n_pad, 1.0),
        torch.arange(n_pad, device=dev) < n, tol, fact.pivots)
    keep = torch.zeros_like(g_theta)
    keep[list(theta_idx)] = 1.0
    return g_theta * keep, g_wn_proj, alpha[:n]
