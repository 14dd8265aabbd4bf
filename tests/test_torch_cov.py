# -*- coding: utf-8 -*-
"""The port's tiled stationary covariance build (``ops/cov.py``) against
the JAX package.

On the CPU the port's Function runs its plain versions; they are held to
the JAX package's XLA route (``compiler._value_builder`` and ``jax.vjp`` of
it, float64) at rtol 1e-10, and to the JAX package's Pallas kernel
(``pallas_cov.make_stationary_cov``) run in interpret mode, float32, at
``tests/test_aux.py``'s tolerances.  The route's decision is checked for
the card without one.  The CUDA kernels themselves are held to the plain
versions by a ``gpu`` test (and by ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from george_tpu import kernels as jk
from george_tpu.dsl import compiler as jcompiler
from george_tpu.ops import pallas_cov

from george_tpu_torch import config as tconfig
from george_tpu_torch import kernels as tk
from george_tpu_torch.dsl import compiler as tcompiler
from george_tpu_torch.ops import cov

RTOL = 1e-10


def _leaves(k):
    """Every stationary spec, under the three metric types."""
    return {
        "exp_squared": k.ExpSquaredKernel(metric=0.8, ndim=2),
        "exp": k.ExpKernel(metric=[0.5, 1.5], ndim=2),
        "matern32": k.Matern32Kernel(metric=[1.0, 2.0], ndim=3, axes=[0, 2]),
        "matern52": k.Matern52Kernel(metric=[[1.0, 0.3], [0.3, 2.0]],
                                     ndim=2),
        "rational_quadratic": k.RationalQuadraticKernel(
            log_alpha=0.3, metric=[1.5, 0.7], ndim=2),
    }


def _points(n, d, seed):
    return np.random.default_rng(seed).uniform(-2.0, 2.0, (n, d))


@pytest.mark.parametrize("name", sorted(_leaves(tk)))
def test_plain_versions_match_jax_xla_route(name):
    """On plain coordinates (unit isotropic metric, so A = X), K and its
    VJP against the JAX XLA builder and ``jax.vjp`` of it."""
    kt = _leaves(tk)[name]
    leaf = kt.spec_node()
    npar = leaf.nparams
    # The same radial function under an isotropic unit metric.
    iso = dict(metric=1.0, ndim=len(leaf.axes))
    if npar:
        iso["log_alpha"] = 0.3
    kj = getattr(jk, type(kt).__name__)(**iso)
    ktu = getattr(tk, type(kt).__name__)(**iso)
    node_j = kj.spec_node()
    rng = np.random.default_rng(1)
    A1 = _points(23, len(leaf.axes), 2)
    A2 = _points(17, len(leaf.axes), 3)
    A2[:5] = A1[:5]                        # r2 = 0 off the diagonal
    g = rng.standard_normal((23, 17))
    theta = np.asarray(ktu.get_parameter_vector(include_frozen=True))
    theta[:npar] += 0.1

    value = jcompiler._value_builder(node_j)
    K_ref, vjp = jax.vjp(value, jnp.asarray(theta), jnp.asarray(A1),
                         jnp.asarray(A2))
    dth, dA1, dA2 = vjp(jnp.asarray(g))

    leaf_u = ktu.spec_node()
    p, a1, a2, gt = (torch.as_tensor(v) for v in (theta[:npar], A1, A2, g))
    K = cov.stationary_cov_torch(leaf_u, p, a1, a2)
    np.testing.assert_allclose(K.numpy(), np.asarray(K_ref), rtol=RTOL)
    dp, da1, da2 = cov.stationary_cov_vjp_torch(leaf_u, p, a1, a2, gt)
    np.testing.assert_allclose(dp.numpy(), np.asarray(dth)[:npar],
                               rtol=RTOL)
    scale = float(np.abs(np.asarray(dA1)).max())
    np.testing.assert_allclose(da1.numpy(), np.asarray(dA1), rtol=RTOL,
                               atol=RTOL * scale)
    np.testing.assert_allclose(da2.numpy(), np.asarray(dA2), rtol=RTOL,
                               atol=RTOL * scale)


@pytest.mark.parametrize("name", sorted(_leaves(tk)))
def test_route_matches_jax_builder(name, monkeypatch):
    """The compiler's kernel route (metric applied outside, the Function's
    forward and closed-form backward, autograd through the metric) against
    the JAX XLA builder and its VJP, every metric type, under
    ``torch.func.vmap`` over parameter vectors too."""
    kj, kt = _leaves(jk)[name], _leaves(tk)[name]
    node_j, node_t = kj.spec_node(), kt.spec_node()
    monkeypatch.setattr(tcompiler, "use_pallas", lambda *a: True)
    rng = np.random.default_rng(4)
    X1 = _points(19, kt.ndim, 5)
    X2 = _points(13, kt.ndim, 6)
    X2[:3] = X1[:3]
    g = rng.standard_normal((19, 13))
    theta0 = np.asarray(kt.get_parameter_vector(include_frozen=True))
    thetas = theta0 + 0.1 * rng.standard_normal((3, len(theta0)))

    value_j = jcompiler._value_builder(node_j)
    value_t = tcompiler._value_builder(node_t)
    for theta in thetas:
        K_ref, vjp = jax.vjp(value_j, jnp.asarray(theta), jnp.asarray(X1),
                             jnp.asarray(X2))
        refs = [np.asarray(v) for v in vjp(jnp.asarray(g))]
        th, x1, x2 = (torch.as_tensor(v).requires_grad_(True)
                      for v in (theta, X1, X2))
        K = value_t(th, x1, x2)
        np.testing.assert_allclose(K.detach().numpy(), np.asarray(K_ref),
                                   rtol=RTOL)
        grads = torch.autograd.grad(K, (th, x1, x2), torch.as_tensor(g))
        for got, ref in zip(grads, refs):
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9,
                                       atol=1e-12 * np.abs(ref).max())

    # vmap over the parameter vectors: the Function's vmap rule, one
    # batched call, and the batched cotangent in its backward.
    G = rng.standard_normal((3, 19, 13))
    Kb_ref, vjp = jax.vjp(jax.vmap(value_j, in_axes=(0, None, None)),
                          jnp.asarray(thetas), jnp.asarray(X1),
                          jnp.asarray(X2))
    refs = [np.asarray(v) for v in vjp(jnp.asarray(G))]
    th = torch.as_tensor(thetas).requires_grad_(True)
    x1 = torch.as_tensor(X1).requires_grad_(True)
    Kb = torch.func.vmap(value_t, in_dims=(0, None, None))(
        th, x1, torch.as_tensor(X2))
    np.testing.assert_allclose(Kb.detach().numpy(), np.asarray(Kb_ref),
                               rtol=RTOL)
    grads = torch.autograd.grad(Kb, (th, x1), torch.as_tensor(G))
    for got, ref in zip(grads, refs):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9,
                                   atol=1e-12 * np.abs(ref).max())


class _InterpretPallas:
    """Run the JAX package's pallas_call in interpret mode (as
    tests/test_aux.py does)."""

    def __enter__(self):
        from jax.experimental import pallas as pl

        self._orig = pl.pallas_call

        def interp(*args, **kwargs):
            kwargs.setdefault("interpret", True)
            return self._orig(*args, **kwargs)

        pallas_cov.pl.pallas_call = interp
        return self

    def __exit__(self, *exc):
        pallas_cov.pl.pallas_call = self._orig


@pytest.mark.parametrize("name,nparams", [
    ("ExpSquaredKernel", 0),
    ("RationalQuadraticKernel", 1),
])
def test_plain_versions_match_interpreted_pallas_kernel(name, nparams):
    """Against the TPU kernel itself (interpret mode, float32, two 256-row
    tiles by one column tile): test_aux's tolerances."""
    radial = jcompiler._radial_fn(name, ())
    leaf = getattr(tk, name)(**(dict(log_alpha=0.3) if nparams else {}),
                             metric=1.0, ndim=2).spec_node()
    rng = np.random.default_rng(0)
    A1 = rng.standard_normal((300, 2)).astype(np.float32)
    A2 = rng.standard_normal((200, 2)).astype(np.float32)
    p = np.full((nparams,), 0.3, np.float32)
    g = rng.standard_normal((300, 200)).astype(np.float32)
    with _InterpretPallas():
        f = pallas_cov.make_stationary_cov(radial, ndim=2, nparams=nparams)
        K_ref, vjp = jax.vjp(f, jnp.asarray(p), jnp.asarray(A1),
                             jnp.asarray(A2))
        refs = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    args = [torch.as_tensor(v, dtype=torch.float64) for v in (p, A1, A2)]
    K = cov.stationary_cov_torch(leaf, *args)
    np.testing.assert_allclose(K.numpy(), np.asarray(K_ref), atol=1e-5)
    got = cov.stationary_cov_vjp_torch(leaf, *args,
                                       torch.as_tensor(g, dtype=torch.float64))
    for a, b in zip(got, refs):
        if b.size:
            scale = max(1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(a.numpy(), b, atol=2e-3 * scale)


def test_route_decision(monkeypatch):
    es = tk.ExpSquaredKernel(1.0).spec_node()
    blocked = tk.ExpSquaredKernel(1.0, block=[(0.0, 1.0)]).spec_node()
    const = tk.ConstantKernel(log_constant=0.0).spec_node()
    f32, f64 = torch.float32, torch.float64
    big, small = 1 << 10, 1 << 9            # 2^20 and 2^18 entries
    use = tcompiler.use_pallas
    monkeypatch.setattr(tconfig, "pallas_covariance", "auto")
    assert use(es, big, big, f32, "cuda")
    assert not use(es, big, small, f32, "cuda")
    assert not use(es, big, big, f64, "cuda")
    assert not use(es, big, big, f32, "cpu")
    assert not use(blocked, big, big, f32, "cuda")
    assert not use(const, big, big, f32, "cuda")
    monkeypatch.setattr(tconfig, "pallas_min_elements", 1 << 18)
    assert use(es, big, small, f32, "cuda")
    monkeypatch.setattr(tconfig, "pallas_covariance", "always")
    assert use(es, 3, 5, f64, "cuda")
    assert not use(es, 3, 5, f64, "cpu")
    assert not use(blocked, 3, 5, f64, "cuda")
    monkeypatch.setattr(tconfig, "pallas_covariance", "never")
    assert not use(es, big, big, f32, "cuda")


def test_cpu_builds_never_launch(monkeypatch):
    """Under "always", a CPU build still takes the plain version."""
    monkeypatch.setattr(tconfig, "pallas_covariance", "always")
    k = 2.0 * tk.RationalQuadraticKernel(log_alpha=0.2, metric=1.3)
    x = np.linspace(0, 5, 40)[:, None]
    fwd, bwd = cov.stationary_cov_fwd.launches, cov.stationary_cov_bwd.launches
    K = k.get_value(x, device="cpu")
    assert K.shape == (40, 40) and np.all(np.isfinite(K))
    with pytest.raises(ValueError, match="CUDA"):
        cov.stationary_cov_fwd(k.k2.spec_node(), torch.zeros(1),
                               torch.zeros(4, 1), torch.zeros(3, 1))
    assert (cov.stationary_cov_fwd.launches,
            cov.stationary_cov_bwd.launches) == (fwd, bwd)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    rng = np.random.default_rng(7)
    for name, k in sorted(_leaves(tk).items()):
        leaf = k.spec_node()
        d = len(leaf.axes)
        # 1000 x 777 spans several row bands and column tiles of the
        # backward kernel in both dimensions, off their multiples.
        for lead, n1, n2 in (((), 300, 257), ((3,), 300, 257),
                             ((), 1000, 777)):
            A1 = rng.standard_normal(lead + (n1, d))
            A2 = rng.standard_normal(lead + (n2, d))
            A2[..., :50, :] = A1[..., :50, :]
            p = 0.3 + 0.1 * rng.standard_normal(lead + (leaf.nparams,))
            g = rng.standard_normal(lead + (n1, n2))
            ref = cov.stationary_cov_torch(
                leaf, *(torch.as_tensor(v) for v in (p, A1, A2)))
            refs = cov.stationary_cov_vjp_torch(
                leaf, *(torch.as_tensor(v) for v in (p, A1, A2, g)))
            launches = cov.stationary_cov_fwd.launches
            args = [torch.as_tensor(v, device="cuda") for v in (p, A1, A2)]
            K = cov.stationary_cov_fwd(leaf, *args)
            got = cov.stationary_cov_bwd(leaf, *args,
                                         torch.as_tensor(g, device="cuda"))
            torch.cuda.synchronize()
            assert cov.stationary_cov_fwd.launches == launches + 1
            # float64: the same formulas in the same type.
            np.testing.assert_allclose(K.cpu().numpy(), ref.numpy(),
                                       rtol=1e-9)
            for a, b in zip(got, refs):
                np.testing.assert_allclose(
                    a.cpu().numpy(), b.numpy(), rtol=1e-9,
                    atol=1e-9 * float(b.abs().max() if b.numel() else 0))
