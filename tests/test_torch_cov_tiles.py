# -*- coding: utf-8 -*-
"""The covariance backward kernel's tiled algorithm
(``csrc/stationary_cov.cu``) as plain PyTorch
(``ops/cov.stationary_cov_vjp_tiles_torch``) against the plain VJP and the
JAX package.

The model cuts g into the kernel's tiles (64-row bands, 512 bytes of
columns), sums W (a1_i - a2_j) within each tile
in the working type and across tiles in float64, and finalizes the strips'
row partials and the bands' column partials in order.  It is held to
``stationary_cov_vjp_torch`` in float64 at rtol 1e-10 for every stationary
spec, at ragged shapes that are not multiples of the tile, batched, with
coincident points and with bands split into strips; its float32 to the
float64 plain VJP within the route gate of ``chip_smoke.py`` (twice the
float32 plain VJP's error plus 16 float32 ulps of the largest magnitude);
and once to ``jax.vjp`` of the JAX package's XLA builder.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from george_tpu import kernels as jk
from george_tpu.dsl import compiler as jcompiler

from george_tpu_torch import kernels as tk
from george_tpu_torch.ops import cov

from test_torch_cov import _leaves

RTOL = 1e-10
EPS32 = float(np.finfo(np.float32).eps)


def _inputs(leaf, lead, n1, n2, seed, coincide=0):
    rng = np.random.default_rng(seed)
    d = len(leaf.axes)
    A1 = rng.uniform(-2.0, 2.0, lead + (n1, d))
    A2 = rng.uniform(-2.0, 2.0, lead + (n2, d))
    if coincide:
        # r2 = 0 off the diagonal
        A2[..., :coincide, :] = A1[..., :coincide, :]
    p = 0.3 + 0.1 * rng.standard_normal(lead + (leaf.nparams,))
    g = rng.standard_normal(lead + (n1, n2))
    return [torch.as_tensor(v) for v in (p, A1, A2, g)]


def _assert_close(got, ref, rtol):
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = float(b.abs().max()) if b.numel() else 0.0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                   atol=rtol * scale)


@pytest.mark.parametrize("name", sorted(_leaves(tk)))
@pytest.mark.parametrize("lead, n1, n2, strips", [
    ((), 300, 257, 3), ((), 129, 1, 1), ((3,), 70, 130, 2)])
def test_tiles_match_plain_vjp(name, lead, n1, n2, strips):
    """float64, ragged N1 != N2 off the tile, batched, strips of a band,
    coincident points."""
    leaf = _leaves(tk)[name].spec_node()
    args = _inputs(leaf, lead, n1, n2, seed=n1 + n2, coincide=min(n1, n2, 40))
    got = cov.stationary_cov_vjp_tiles_torch(leaf, *args, strips=strips)
    _assert_close(got, cov.stationary_cov_vjp_torch(leaf, *args), RTOL)


@pytest.mark.parametrize("name", ["exp", "rational_quadratic"])
def test_float32_tiles_within_route_gate(name):
    """In-tile sums in float32: the model's float32 error against the
    float64 plain VJP at most twice the float32 plain VJP's, plus 16
    float32 ulps of the largest magnitude."""
    leaf = _leaves(tk)[name].spec_node()
    args = _inputs(leaf, (), 300, 257, seed=11, coincide=40)
    ref = cov.stationary_cov_vjp_torch(leaf, *args)
    a32 = [a.float() for a in args]
    tiles = cov.stationary_cov_vjp_tiles_torch(leaf, *a32, strips=2)
    plain = cov.stationary_cov_vjp_torch(leaf, *a32)
    for t, q, r in zip(tiles, plain, ref):
        if not r.numel():
            continue
        scale = float(r.abs().max())
        e_t = float((t.double() - r).abs().max())
        e_p = float((q.double() - r).abs().max())
        assert t.dtype == torch.float32
        assert e_t <= 2.0 * e_p + 16 * EPS32 * scale, (e_t, e_p, scale)


def test_tiles_match_jax_vjp():
    """One case against ``jax.vjp`` of the JAX package's XLA builder
    (jitted), on plain coordinates (unit isotropic metric, so A = X) with a
    radial parameter."""
    kw = dict(log_alpha=0.3, metric=1.0, ndim=2)
    kj, kt = jk.RationalQuadraticKernel(**kw), tk.RationalQuadraticKernel(**kw)
    leaf = kt.spec_node()
    rng = np.random.default_rng(2)
    A1 = rng.uniform(-2.0, 2.0, (150, 2))
    A2 = rng.uniform(-2.0, 2.0, (131, 2))
    A2[:20] = A1[:20]
    g = rng.standard_normal((150, 131))
    theta = np.asarray(kt.get_parameter_vector(include_frozen=True))
    theta[0] += 0.1

    value = jcompiler._value_builder(kj.spec_node())

    @jax.jit
    def vjp(th, x1, x2, ct):
        return jax.vjp(value, th, x1, x2)[1](ct)

    dth, dA1, dA2 = vjp(*(jnp.asarray(v) for v in (theta, A1, A2, g)))
    dp, da1, da2 = cov.stationary_cov_vjp_tiles_torch(
        leaf, *(torch.as_tensor(v) for v in (theta[:1], A1, A2, g)),
        strips=2)
    np.testing.assert_allclose(dp.numpy(), np.asarray(dth)[:1], rtol=RTOL)
    scale = float(np.abs(np.asarray(dA1)).max())
    np.testing.assert_allclose(da1.numpy(), np.asarray(dA1), rtol=RTOL,
                               atol=RTOL * scale)
    np.testing.assert_allclose(da2.numpy(), np.asarray(dA2), rtol=RTOL,
                               atol=RTOL * scale)
