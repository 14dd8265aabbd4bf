# -*- coding: utf-8 -*-
"""The Kalman kernel's split of a series into segments, modelled in PyTorch.

``csrc/kalman_vg.cu`` spreads one chain's series over S segments: segment 0
filters, every later one folds its observations into an element of the
associative-scan filter, carries segment 0's end state through the elements
before it, and re-filters.  ``ops/kalman.kalman_vg_segmented_torch`` runs
those stages in the kernel's order; here it is held in float64 to the
sequential plain version (``kalman_vg_torch``) and to the JAX package's scan
density on the same numpy inputs, and in float32 to the float32 sequential
filter's own error.  The kernel itself is compared on the card
(``gpu`` marker; ``chip_smoke.py`` phases 2, 8 and 10).
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from george_tpu import kernels as jk
from george_tpu.ops import state_space as jss

from george_tpu_torch import _build
from george_tpu_torch import kernels as tk
from george_tpu_torch.ops import kalman
from george_tpu_torch.ops import state_space as tss

from test_torch_kalman import _dataset, _thetas, _zoo

# One intra-op thread: the tensors here are small, and the suite's workers
# run side by side (several threads each cost more than they gain).
torch.set_num_threads(1)


def _case(name, n):
    """(vg, thetas): the zoo kernel with a fitted mean and log white noise,
    every parameter active."""
    x, y, yerr = _dataset(n=n, seed=31)
    th_k = _zoo(tk)[name]().get_parameter_vector()
    vg = kalman.make_kalman_vg(_zoo(tk)[name]().spec_node(), x, y, yerr ** 2,
                               1, 1, tuple(range(len(th_k) + 2)))
    base = np.concatenate([[0.1, np.log(1e-3)], th_k])
    return vg, _thetas(base, 3, 0.2, seed=32), (x, y, yerr)


@lru_cache(maxsize=None)
def _jax_reference(name, n):
    """The JAX package's scan density (its stacked sequential filter) with
    the same mean and white-noise layout, value and gradient per chain."""
    vg, thetas, (x, y, yerr) = _case(name, n)
    ll = jss.state_space_loglike_fn(_zoo(jk)[name]().spec_node(),
                                    method="sequential_stacked")

    def f(th):
        return ll(th[2:], jnp.asarray(x), jnp.asarray(y) - th[0],
                  jnp.asarray(yerr ** 2) + jnp.exp(th[1]))

    ref, g = jax.jit(jax.vmap(jax.value_and_grad(f)))(jnp.asarray(thetas))
    return np.asarray(ref), np.asarray(g)


def test_segment_bounds():
    assert kalman.segment_bounds(1000, 1) == [0, 1000]
    assert kalman.segment_bounds(1000, 4) == [0, 250, 500, 750, 1000]
    assert kalman.segment_bounds(100, 3) == [0, 33, 66, 100]
    # Fewer observations than segments: segment 0 keeps the first one,
    # later segments may be empty.
    assert kalman.segment_bounds(1, 4) == [0, 1, 1, 1, 1]
    assert kalman.segment_bounds(2, 7) == [0, 1, 1, 1, 1, 1, 1, 2]
    for n in (1, 2, 5, 48, 1001):
        for S in (1, 2, 3, 7, 64):
            b = kalman.segment_bounds(n, S)
            assert len(b) == S + 1 and b[0] == 0 and b[-1] == n
            assert b[1] >= 1 and all(u <= w for u, w in zip(b, b[1:]))


def test_launcher_choice():
    # One chain a thread where the chains fill the card; a split where they
    # do not, up to ~1024 warps, or 2048 where segments stay long; segments
    # of 32 observations or more, never S = 2, and never a state held to
    # S = 1.
    assert kalman.choose_segments(16384, 1000, 2) == 1
    assert kalman.choose_segments(4096, 1000, 2) == 8
    assert kalman.choose_segments(1024, 1000, 2) == 16
    assert kalman.choose_segments(1024, 100000, 2) == 64
    assert kalman.choose_segments(32, 100000, 2) == 128
    assert kalman.choose_segments(2, 32769, 2) == 128
    assert kalman.choose_segments(256, 100, 2) == 1
    assert kalman.choose_segments(1024, 100000, 6) == 1


def test_cluster_shape():
    # Blocks of at most 4 warps where 16 blocks do, else up to 8 warps.
    assert kalman.cluster_shape(2) == (1, 2)
    assert kalman.cluster_shape(7) == (7, 1)
    assert kalman.cluster_shape(16) == (4, 4)
    assert kalman.cluster_shape(64) == (16, 4)
    assert kalman.cluster_shape(128) == (16, 8)
    with pytest.raises(ValueError, match="do not split"):
        kalman.cluster_shape(17)


@pytest.mark.parametrize("n", [1, 2, 5, 48])
@pytest.mark.parametrize("segments", [1, 2, 3, 7])
@pytest.mark.parametrize("name", sorted(_zoo(tk)))
def test_segmented_model_matches_sequential(name, segments, n):
    vg, thetas, _ = _case(name, n)
    th = torch.as_tensor(thetas)
    series = vg.series(th)
    ll_ref, g_ref = kalman.kalman_vg_torch(vg.spec, th, *series)
    ll, g = kalman.kalman_vg_segmented_torch(vg.spec, th, *series, segments)
    # float64: the boundary states are the only new rounding.
    np.testing.assert_allclose(ll.numpy(), ll_ref.numpy(), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-8,
                               atol=1e-8)
    # JAX compiles its scan per kernel and length (about a second each):
    # every kernel at N = 48; the shorter series through kalman_vg_torch,
    # which tests/test_torch_kalman.py holds to the same JAX filters.
    if n == 48:
        ref, ref_g = _jax_reference(name, n)
        np.testing.assert_allclose(ll.numpy(), ref, rtol=1e-10)
        np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-8, atol=1e-8)


def test_fold_is_the_scan_combine():
    # A segment's element, folded one observation at a time as the kernel
    # does, is the associative-scan filter's product of the step elements.
    vg, thetas, _ = _case("sum3", 12)
    th = torch.as_tensor(thetas)
    dt, y, v = vg.series(th)
    n_scalar = vg.spec.n_mean + vg.spec.n_wn
    fm = tss._FilterMachine(vg.spec.terms, th[:, n_scalar:])
    Phi, Q, Pinf = fm.systems(fm.sig_rates(th[:, n_scalar:]), dt)
    r = (y[None] - th[:, :1]).transpose(0, 1)
    var = (v[None] + torch.exp(th[:, 1:2])).transpose(0, 1)
    steps = tss.filter_elements(fm, Phi, Q, Pinf, r, var)
    B, D = th.shape[0], fm.D
    E = (fm.eye.expand(B, D, D), th.new_zeros(B, D), th.new_zeros(B, D, D),
         th.new_zeros(B, D), th.new_zeros(B, D, D))
    prod = None
    for k in range(4, 11):
        E = kalman._fold(fm, E, Phi[k - 1], Q[k - 1], r[k], var[k])
        e_k = tuple(a[k] for a in steps)
        prod = e_k if prod is None else tss.combine(prod, e_k)
    for a, b in zip(E, prod):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-12)


def test_float32_at_the_posterior_scale():
    # The main path's model at its posterior (length scale ~4.5, gaps
    # ~0.01): float32 Q = Pinf - Phi Pinf Phi^T cancels to a few digits in
    # every filter, so the split is held to the float32 sequential filter's
    # own error against float64, as chip_smoke.py holds the kernel.
    rng = np.random.default_rng(33)
    n = 2000
    x = np.sort(rng.uniform(0, 20, n))
    yerr = 0.1 * np.ones(n)
    y = np.sin(x) + yerr * rng.standard_normal(n)
    node = (1.0 * tk.Matern32Kernel(1.0)).spec_node()
    vg = kalman.make_kalman_vg(node, x, y, yerr ** 2, 1, 1, (1, 2, 3))
    base = np.array([0.0, np.log(1e-4), 0.0, np.log(4.5 ** 2)])
    th64 = torch.as_tensor(base[None] + rng.standard_normal((4, 4))
                           * np.array([0.0, 0.3, 0.3, 0.1]))
    th32 = th64.float()
    ll_ref, g_ref = kalman.kalman_vg_torch(vg.spec, th64, *vg.series(th64))
    ll_p, g_p = kalman.kalman_vg_torch(vg.spec, th32, *vg.series(th32))
    ll_s, g_s = kalman.kalman_vg_segmented_torch(vg.spec, th32,
                                                 *vg.series(th32), 8)
    plain_ll = float((ll_p.double() - ll_ref).abs().max())
    plain_g = float((g_p.double() - g_ref).abs().max())
    assert float((ll_s.double() - ll_ref).abs().max()) <= 2 * plain_ll
    assert float((g_s.double() - g_ref).abs().max()) <= 2 * plain_g


@pytest.mark.gpu
def test_cuda_kernel_at_forced_segments():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    # Every instantiation a split runs, at once (one nvcc each, in parallel).
    _build.build_many([_case(name, 1)[0].spec.instance(torch.float64)
                       for name in sorted(_zoo(tk))
                       if _case(name, 1)[0].spec.dim <= kalman.MAX_SPLIT_DIM])
    for name in sorted(_zoo(tk)):
        for n in (1, 2, 5, 48):
            vg, thetas, _ = _case(name, n)
            th = torch.as_tensor(thetas)
            ll_ref, g_ref = kalman.kalman_vg_torch(vg.spec, th,
                                                   *vg.series(th))
            thc = th.cuda()
            for segments in (2, 4, 7, 64):
                if vg.spec.dim > kalman.MAX_SPLIT_DIM:
                    with pytest.raises(ValueError, match="held to"):
                        kalman.kalman_vg(vg.spec, thc, *vg.series(thc),
                                         segments=segments)
                    continue
                launches = kalman.kalman_vg.launches
                ll, g = kalman.kalman_vg(vg.spec, thc, *vg.series(thc),
                                         segments=segments)
                torch.cuda.synchronize()
                assert kalman.kalman_vg.launches == launches + 1
                # float64: the same formulas, rounded in another order.
                np.testing.assert_allclose(ll.cpu().numpy(), ll_ref.numpy(),
                                           rtol=1e-9, err_msg=name)
                np.testing.assert_allclose(g.cpu().numpy(), g_ref.numpy(),
                                           rtol=1e-8, atol=1e-9,
                                           err_msg=name)
