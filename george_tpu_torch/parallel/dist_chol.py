# -*- coding: utf-8 -*-
"""Distributed blocked Cholesky over a mesh axis (``torch.distributed``).

The dense counterpart of the HODLR tree for large N: the O(N^3)
factorization distributes over the ranks of an axis, so K never exists
whole on one rank.

Layout: K is sharded by **contiguous row blocks**; each rank holds an
(N/P, N) stripe, kept as N/B column chunks of width B (separate tensors:
autograd keeps no copy of the stripe per panel, and nothing is updated in
place).  The factorization is right-looking over column panels:

  1. the panel column (N, B) is assembled with one ``all_gather`` of each
     rank's (N/P, B) chunk;
  2. every rank factorizes the (B, B) diagonal block
     (``torch.linalg.cholesky_ex``; a failed block makes the
     log-determinant NaN) and triangular-solves the panel's rows;
  3. the trailing update ``K -= L_panel L_panel^T`` is one (N/P, B) x
     (B, N - off - B) ``torch.matmul`` a panel, over the chunks right of it.

Rows above the panel are zeroed in the panel instead of skipped (uniform
shapes; the final lower-triangle mask removes them either way).

The solves are blocked substitutions: the (B,) panel pieces of x are
produced in order, and the inner products against the committed part
reduce across the axis with ``psum``: each rank only ever touches its own
row stripe.

Functions named ``*_local`` run on every rank of the axis with this rank's
stripe; :func:`distributed_cholesky` takes the global matrix, as the JAX
function takes it under its ``in_specs``, and returns global results on
every rank.  The collectives are :mod:`.collectives`'s, so gradients
through :func:`distributed_loglike_fn` are right: its hyperparameters enter
through ``pvary`` and its value leaves through ``pmean``.
"""

import math

import torch

from .collectives import all_gather, pmean, psum, pvary
from .mesh import shard

__all__ = [
    "cholesky_local", "solve_local", "distributed_cholesky",
    "distributed_loglike_fn",
]


def _global_rows(n_local, axis, device):
    """Global indices of this rank's rows."""
    return axis.index * n_local + torch.arange(n_local, device=device)


def _chunks(K_local, block_size):
    n = K_local.shape[1]
    if n % block_size:
        raise ValueError("N must be a multiple of block_size")
    return list(torch.split(K_local, block_size, dim=1))


def _factor_chunks(chunks, axis, block_size):
    """The panel loop: the factor's column chunks and the log-determinant."""
    n_local = chunks[0].shape[0]
    grows = _global_rows(n_local, axis, chunks[0].device)
    logdet = chunks[0].new_zeros(())
    nb = len(chunks)
    for k in range(nb):
        off = k * block_size
        col = chunks[k]                                  # (n_loc, B)
        full_col = all_gather(col, axis)                 # (N, B)
        Ld, info = torch.linalg.cholesky_ex(full_col[off:off + block_size])
        # A failed block (K not positive definite) makes logdet NaN.
        part = 2.0 * torch.sum(torch.log(torch.diagonal(Ld)))
        logdet = logdet + torch.where(info == 0, part,
                                      torch.full_like(part, math.nan))
        # Panel rows: col @ inv(Ld)^T.  For the diagonal block's rows this
        # is Ld itself (D = Ld Ld^T); rows above the panel are zeroed.
        Lp_loc = torch.linalg.solve_triangular(Ld, col.T, upper=False).T
        Lp_loc = torch.where((grows >= off)[:, None], Lp_loc,
                             torch.zeros_like(Lp_loc))
        chunks[k] = Lp_loc
        if k + 1 < nb:
            rest = full_col[off + block_size:]           # (N - off - B, B)
            Lp_rest = torch.linalg.solve_triangular(Ld, rest.T,
                                                    upper=False).T
            upd = Lp_loc @ Lp_rest.T                     # (n_loc, ...)
            for j, u in enumerate(torch.split(upd, block_size, dim=1)):
                chunks[k + 1 + j] = chunks[k + 1 + j] - u
    return chunks, logdet


def cholesky_local(K_local, axis_name, block_size=256):
    """Distributed lower-Cholesky of a row-sharded SPD matrix.

    Run on every rank of ``axis_name``.  ``K_local`` is this rank's (N/P, N)
    row stripe; N must be a multiple of ``P * block_size`` (pad with
    identity rows/cols — see :func:`distributed_loglike_fn`).  Returns
    ``(L_local, logdet)`` with ``L_local`` the same stripe of the lower
    factor and ``logdet`` the same on every rank.
    """
    n_local, n = K_local.shape
    chunks, logdet = _factor_chunks(_chunks(K_local, block_size), axis_name,
                                    block_size)
    L_local = torch.cat(chunks, dim=1)
    grows = _global_rows(n_local, axis_name, K_local.device)
    cols = torch.arange(n, device=K_local.device)
    L_local = torch.where(grows[:, None] >= cols[None, :], L_local,
                          torch.zeros_like(L_local))
    return L_local, logdet


def _reduce_panel(L_local, grows, off, block_size, acc, axis):
    """The panel's diagonal block and the accumulator ``acc`` (B,), each
    summed over the axis in one collective.

    The panel's rows (of the rank that holds them) go to their slots of
    the block, the other rows contribute zeros.  Every rank computes its
    parts by the same operations, so every rank's backward pass makes the
    same collectives.
    """
    in_panel = (grows >= off) & (grows < off + block_size)
    slot = torch.clamp(grows - off, 0, block_size - 1)
    cols = L_local[:, off:off + block_size]
    D = L_local.new_zeros((block_size, block_size)).index_add(
        0, slot, torch.where(in_panel[:, None], cols, torch.zeros_like(cols)))
    DA = psum(torch.cat([D.reshape(-1), acc]), axis)
    return (DA[:-block_size].reshape(block_size, block_size),
            DA[-block_size:])


def _fwd_subst_local(L_local, b, axis, block_size):
    """x with L x = b; ``L_local`` row stripe, ``b`` / ``x`` whole on every
    rank."""
    n_local, n = L_local.shape
    grows = _global_rows(n_local, axis, L_local.device)
    pieces = [b.new_zeros((0,))]
    for k in range(n // block_size):
        off = k * block_size
        # acc = L[panel rows, :off] @ x[:off], summed across the axis.
        in_panel = (grows >= off) & (grows < off + block_size)
        partial = L_local[:, :off] @ torch.cat(pieces)
        acc = partial.new_zeros((block_size,)).index_add(
            0, torch.clamp(grows - off, 0, block_size - 1),
            torch.where(in_panel, partial, torch.zeros_like(partial)))
        D, acc = _reduce_panel(L_local, grows, off, block_size, acc, axis)
        rhs = (b[off:off + block_size] - acc)[:, None]
        pieces.append(torch.linalg.solve_triangular(D, rhs,
                                                    upper=False)[:, 0])
    return torch.cat(pieces)


def _bwd_subst_local(L_local, b, axis, block_size):
    """x with L^T x = b; panels sweep bottom-up."""
    n_local, n = L_local.shape
    nb = n // block_size
    grows = _global_rows(n_local, axis, L_local.device)
    pieces = []
    for i in range(nb):
        k = nb - 1 - i
        off = k * block_size
        # acc = L[below rows, panel cols]^T @ x[below], summed across the
        # axis: x below the panel is known, zero down to it.
        x_known = torch.cat([b.new_zeros((off + block_size,))]
                            + pieces[::-1])
        acc = L_local[:, off:off + block_size].T @ x_known[grows]
        D, acc = _reduce_panel(L_local, grows, off, block_size, acc, axis)
        rhs = (b[off:off + block_size] - acc)[:, None]
        pieces.append(torch.linalg.solve_triangular(D.T, rhs,
                                                    upper=True)[:, 0])
    return torch.cat(pieces[::-1])


def solve_local(L_local, b, axis_name, block_size=256):
    """K^{-1} b from the distributed factor (two blocked substitutions)."""
    z = _fwd_subst_local(L_local, b, axis_name, block_size)
    return _bwd_subst_local(L_local, z, axis_name, block_size)


def distributed_cholesky(K, mesh, axis_name="data", block_size=256):
    """Factor a global K over the ranks of ``mesh``'s ``axis_name``.

    Returns ``(L, logdet)`` with L whole on every rank (use the ``_local``
    functions on stripes to keep everything sharded).  N is padded with an
    identity block to a multiple of ``P * block_size``.
    """
    axis = mesh.axis(axis_name)
    K = torch.as_tensor(K, device=mesh.device)
    n = K.shape[0]
    step = axis.size * block_size
    n_pad = -(-n // step) * step
    if n_pad != n:
        K = torch.nn.functional.pad(K, (0, n_pad - n, 0, n_pad - n))
        idx = torch.arange(n, n_pad, device=K.device)
        K = K.index_put((idx, idx), torch.ones_like(idx, dtype=K.dtype))
    L_local, logdet = cholesky_local(shard(K, axis), axis, block_size)
    L = all_gather(L_local, axis)
    return L[:n, :n], pmean(logdet, axis)


def distributed_loglike_fn(kernel_value, mean_fn, wn_fn, n_total,
                           axis_name, block_size=256, n_real=None):
    """Fully-distributed GP marginal log-likelihood (every rank of the
    axis).

    Returns ``ll(theta_kernel, theta_mean, theta_wn, x_local, y_local,
    yerr2_local)`` for one parameter vector, where the data are this rank's
    row shard.  The covariance never exists unsharded: each rank builds
    its (N/P, N) row stripe (``kernel_value``, the compiler's builder: on
    the card a launch of the covariance kernel), the factorization is
    :func:`cholesky_local`, and the quadratic form reduces with ``psum``.
    ``mean_fn`` / ``wn_fn`` are ``(params (1, p), x) -> (1, n) or (n,)``
    and must take any number of rows.  ``n_total`` (the padded, sharded
    size) must be a multiple of ``P * block_size``; when ``n_real <
    n_total`` the padded rows/columns become the identity (zero covariance,
    unit diagonal, zero residual), so they contribute nothing to logdet or
    the quadratic form.
    """
    if n_real is None:
        n_real = n_total
    axis = axis_name

    def model(fn, params, x):
        return fn(params[None], x).reshape(-1)

    def ll(th_kernel, th_mean, th_wn, x_local, y_local, yerr2_local):
        n_local = x_local.shape[0]
        device = x_local.device
        grows = _global_rows(n_local, axis, device)
        th_kernel, th_mean, th_wn = (pvary(t, axis)
                                     for t in (th_kernel, th_mean, th_wn))
        x_full = all_gather(x_local, axis)
        y_full = all_gather(y_local, axis)
        vloc = grows < n_real
        vfull = torch.arange(n_total, device=device) < n_real

        stripe = kernel_value(th_kernel, x_local, x_full)   # (n_loc, N)
        if n_real != n_total:
            stripe = torch.where(vloc[:, None] & vfull[None, :], stripe,
                                 torch.zeros_like(stripe))
        diag_noise = yerr2_local + torch.exp(model(wn_fn, th_wn, x_local))
        if n_real != n_total:
            diag_noise = torch.where(vloc, diag_noise,
                                     torch.ones_like(diag_noise))
        stripe = stripe.index_put(
            (torch.arange(n_local, device=device), grows), diag_noise,
            accumulate=True)

        L_local, logdet = cholesky_local(stripe, axis, block_size)
        r = y_full - model(mean_fn, th_mean, x_full)
        if n_real != n_total:
            r = torch.where(vfull, r, torch.zeros_like(r))
        alpha = solve_local(L_local, r, axis, block_size)
        norm = n_real * math.log(2.0 * math.pi)
        out = -0.5 * (norm + logdet + torch.dot(r, alpha))
        # Every rank computed the same scalar.  pmean makes it one value
        # for autograd: its backward hands each rank 1/P of the cotangent,
        # and the pvary above sums the ranks' parameter gradients.
        return pmean(out, axis)

    return ll
