# -*- coding: utf-8 -*-
"""The dense value+gradient kernel's tiled algorithm, on the CPU.

The CUDA kernel (``csrc/dense_vg.cu``) runs only on the card.  Here a plain
PyTorch model of its algorithm, in float64 and in the kernel's order of
tile operations, is held to ``ops/dense.dense_vg_torch`` (a ``cholesky_ex``
and autograd) at rtol 1e-10 on config #5's model:

  * N padded to a multiple of 16 with the identity (K_pad = diag(K, I),
    r_pad = 0);
  * the blocked factor and inverse over nb = N_pad / 16 tiles a side
    (``tests/test_torch_tile_chol.py``'s ``factor_invert_tiles``);
  * z = T r by tile-rows and alpha = T^T z by tile-columns;
  * K^-1 = T^T T in place, in rounds of one tile a warp (8 warps up to
    N = 128, 16 above) in row-major order from the top, each round summed
    from the tiles as they stand before any of its tiles is written: a
    wrong order would read a tile of K^-1 where T is due;
  * the gradient over the lower tiles, weight 1/2 on the diagonal, the
    padding skipped (dK contracted with the weights by one backward pass
    through the build).

A chain whose factorization fails reads NaN in ll and gradient, and only
that chain.  At N = 136 the model is also held to the JAX package's plain
``xla_dense`` route.
"""

import math

import numpy as np
import pytest
import torch

from george_tpu.samplers import build_gp_log_prob as jax_build
from george_tpu_torch import kernels as tk
from george_tpu_torch.dsl import compiler
from george_tpu_torch.ops import dense

from test_torch_dense import (G_ATOL, G_RTOL, LL_RTOL, _config5, _dataset,
                              _jax_vg, _pair, _thetas)
from test_torch_tile_chol import SIDE, factor_invert_tiles

# One intra-op thread: the tensors here are small, and the suite's workers
# run side by side (several threads each cost more than they gain).
torch.set_num_threads(1)

# csrc/dense_vg.cu's warps a block: DV_WARPS up to 8 tiles a side, else
# DV_WARPS_WIDE.
WARPS, WARPS_WIDE = 8, 16
BASE = np.array([0.1, np.log(1e-3), 0.0, 0.0, np.log(2.0)])


def dense_tile_model(vg, theta):
    """(ll, grad) of :class:`dense.DenseVG` ``vg`` at ``theta`` (B, D_full)
    by the kernel's tile steps."""
    spec = vg.spec
    x, y, v = vg.data(theta)
    n, B = y.shape[0], theta.shape[0]
    nb = -(-n // SIDE)
    pad = SIDE * nb - n
    m, ns = spec.n_mean, spec.n_mean + spec.n_wn
    build = compiler.kernel_value_fn(spec.node)

    th = theta.detach().clone().requires_grad_(True)
    K = torch.func.vmap(build, in_dims=(0, None, None))(th[:, ns:], x, x)
    noise = v + torch.exp(th[:, m:m + 1]) if spec.n_wn else v.expand(B, n)
    K = K + torch.diag_embed(noise)
    ones = torch.cat([torch.zeros(n), torch.ones(pad)]).to(K)
    Kp = torch.nn.functional.pad(K, (0, pad, 0, pad)) + torch.diag(ones)

    A, logdet, ok = factor_invert_tiles(Kp.detach())
    r = torch.nn.functional.pad(y - theta[:, :1] if m else y.expand(B, n),
                                (0, pad))

    def seg(vec, k):
        return vec[:, SIDE * k:SIDE * (k + 1), None]

    z = [sum(A[i, k] @ seg(r, k) for k in range(i + 1)) for i in range(nb)]
    alpha = [sum(A[i, k].transpose(1, 2) @ z[i] for i in range(k, nb))
             for k in range(nb)]
    z, alpha = torch.cat(z, 1)[..., 0], torch.cat(alpha, 1)[..., 0]

    order = [(i, j) for i in range(nb) for j in range(i + 1)]
    warps = WARPS if nb <= 8 else WARPS_WIDE
    for t0 in range(0, len(order), warps):
        A.update({(i, j): sum(A[k, i].transpose(1, 2) @ A[k, j]
                              for k in range(i, nb))
                  for i, j in order[t0:t0 + warps]})

    idx = torch.arange(SIDE)
    weights = torch.zeros_like(Kp)
    for i, j in order:
        gi, gj = SIDE * i + idx, SIDE * j + idx
        w = seg(alpha, i) * seg(alpha, j).transpose(1, 2) - A[i, j]
        keep = (gi[:, None] < n) & (gj[None, :] < n)
        if i == j:
            keep &= idx[None, :] <= idx[:, None]
            w = w * torch.where(idx[:, None] == idx[None, :], 0.5, 1.0)
        weights[:, SIDE * i:SIDE * (i + 1), SIDE * j:SIDE * (j + 1)] = \
            torch.where(keep, w, 0.0)
    g = torch.autograd.grad((weights * Kp).sum(), th)[0]
    if m:
        g[:, 0] = alpha.sum(1)
    g = g[:, list(spec.active)]
    ll = -0.5 * (n * math.log(2.0 * math.pi) + logdet + (z * z).sum(1))
    nan = torch.tensor(float("nan"), dtype=ll.dtype)
    return torch.where(ok, ll, nan), torch.where(ok[:, None], g, nan)


def _config5_vg(n, seed):
    x, y, yerr = _dataset(n=n, seed=seed)
    node = _config5(tk)["kernel"].spec_node()
    return dense.make_dense_batched_vg(node, x, y, yerr ** 2, 1, 1,
                                       (0, 1, 2, 3, 4))


def _hold(ll, g, ll_ref, g_ref):
    np.testing.assert_allclose(ll.numpy(), ll_ref.numpy(), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-10,
                               atol=1e-10 * float(g_ref.abs().max()))


@pytest.mark.parametrize("n", [16, 40, 128, 136, 256])
def test_tile_model_matches_dense_vg_torch(n):
    vg = _config5_vg(n, seed=n)
    theta = torch.as_tensor(_thetas(BASE, 3, 0.2, seed=n))
    ll, g = dense_tile_model(vg, theta)
    ll_ref, g_ref = dense.dense_vg_torch(vg.spec, theta, *vg.data(theta))
    assert bool(torch.all(torch.isfinite(ll_ref)))
    _hold(ll, g, ll_ref, g_ref)


def test_failed_factorization_is_nan_on_its_chain_alone():
    vg = _config5_vg(40, seed=1)
    th = _thetas(BASE, 4, 0.2, seed=2)
    th[2, 2] = 1000.0       # the log amplitude overflows: K is inf
    theta = torch.as_tensor(th)
    ll, g = dense_tile_model(vg, theta)
    ll_ref, g_ref = dense.dense_vg_torch(vg.spec, theta, *vg.data(theta))
    bad = torch.tensor([False, False, True, False])
    assert torch.equal(torch.isnan(ll), bad)
    assert torch.equal(torch.isnan(ll_ref), bad)
    assert bool(torch.all(torch.isnan(g[2])))
    assert bool(torch.all(torch.isfinite(g[~bad])))
    _hold(ll[~bad], g[~bad], ll_ref[~bad], g_ref[~bad])


def test_tile_model_matches_jax_dense_at_136():
    x, y, yerr = _dataset(n=136, seed=3)
    gj, gt = _pair(_config5)
    lp_j, theta0 = jax_build(gj, x, y, yerr, method="dense")
    assert lp_j.engine == "xla_dense"
    thetas = _thetas(theta0, 3, 0.2, seed=4)
    vg = dense.make_dense_batched_vg(gt.kernel.spec_node(), x, y, yerr ** 2,
                                     1, 1, tuple(range(thetas.shape[1])))
    ll, g = dense_tile_model(vg, torch.as_tensor(thetas))
    ref_lp, ref_g = _jax_vg(lp_j, thetas)
    np.testing.assert_allclose(ll.numpy(), ref_lp, rtol=LL_RTOL)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=G_RTOL, atol=G_ATOL)
