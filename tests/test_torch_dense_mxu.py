# -*- coding: utf-8 -*-
"""The port's blocked dense engine (``ops/dense_mxu.py``) and the batched
A B^T (``ops/batched_mm.py``) against the JAX package.

Oracles, all on the CPU: the JAX package's plain dense route,
``vmap(value_and_grad(log_prob))`` of ``xla_dense`` in x64, for the port's
float64 engine; its own blocked engine with the Pallas spine in interpret
mode (float32, as that engine always runs) for the port's float32 engine
and for the spine's plain version; the JAX benchmark's einsum for the
batched product.  Inputs are made with numpy from a seed and handed to both
packages as numpy; GP parameters cross with
``convert.load_reference_parameters``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import george_tpu
from george_tpu import config as jconfig
from george_tpu import kernels as jk
from george_tpu.ops import dense_mxu as jdm
from george_tpu.samplers import build_gp_log_prob as jax_build

import george_tpu_torch
from george_tpu_torch import config as tconfig
from george_tpu_torch import kernels as tk
from george_tpu_torch.convert import load_reference_parameters
from george_tpu_torch.ops import batched_mm, dense_mxu
from george_tpu_torch.samplers import build_gp_log_prob as torch_build

# One intra-op thread: the tensors here are small, and the suite's workers
# run side by side (several threads each cost more than they gain).
torch.set_num_threads(1)

# float64 on both sides; the port factors blockwise (explicit inverse
# blocks, W = T^T T) where JAX's oracle calls one Cholesky and autograd:
# value and gradient to 1e-8.
RTOL64, ATOL64 = 1e-8, 1e-10


@pytest.fixture
def mxu_on():
    old = (tconfig.dense_mxu_sampling, tconfig.dense_mxu_min_n)
    tconfig.dense_mxu_sampling = True
    yield
    tconfig.dense_mxu_sampling, tconfig.dense_mxu_min_n = old


def _dataset(n, d=3, seed=0):
    """tests/test_dense_mxu.py's dataset."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 8, (n, d))
    yerr = 0.1 * np.ones(n)
    y = np.sin(x[:, 0]) + yerr * rng.standard_normal(n)
    return x, y, yerr


def _config5(k):
    return dict(kernel=1.0 * k.Matern32Kernel(metric=[1.0, 2.0], ndim=3,
                                              axes=[0, 2]),
                white_noise=np.log(1e-3), fit_white_noise=True, mean=0.0,
                fit_mean=True)


def _general(k):
    return dict(kernel=1.0 * k.ExpSquaredKernel(
        metric=[[1.0, 0.1], [0.1, 2.0]], ndim=2),
        white_noise=np.log(1e-3), fit_white_noise=True)


def _sum(k):
    return dict(kernel=1.0 * k.Matern32Kernel(metric=[1.0, 2.0], ndim=3,
                                              axes=[0, 2])
                + 0.5 * k.ExpSquaredKernel(metric=2.0, ndim=3, axes=[1]),
                white_noise=np.log(1e-3), fit_white_noise=True)


def _bounded(k):
    return dict(kernel=2.0 * k.ExpSquaredKernel(
        metric=1.0, metric_bounds=[(-2.0, 2.0)], ndim=3, axes=[1]))


def _pair(kwargs_of, freeze=None, seed=0):
    """The same GP in both packages: the JAX one's parameters jittered and
    carried across by ``load_reference_parameters``."""
    gj = george_tpu.GP(**kwargs_of(jk))
    if freeze:
        gj.freeze_parameter(freeze)
    v = np.asarray(gj.get_parameter_vector(include_frozen=True))
    gj.set_parameter_vector(
        v + 0.05 * np.random.default_rng(seed).standard_normal(len(v)),
        include_frozen=True)
    gt = george_tpu_torch.GP(device="cpu", **kwargs_of(tk))
    load_reference_parameters(
        gt, gj.get_parameter_names(include_frozen=True),
        np.asarray(gj.get_parameter_vector(include_frozen=True)),
        np.asarray(gj.unfrozen_mask))
    return gj, gt


def _thetas(theta0, count, scale, seed):
    rng = np.random.default_rng(seed)
    return np.asarray(theta0)[None, :] + scale * rng.standard_normal(
        (count, len(theta0)))


def _jax_vg(log_prob, thetas):
    lp, g = jax.jit(jax.vmap(jax.value_and_grad(log_prob)))(
        jnp.asarray(thetas))
    return np.asarray(lp), np.asarray(g)


def _spd_blocks(count, seed):
    """(count, 128, 128) SPD blocks G G^T / 128 + 0.5 I."""
    G = np.random.default_rng(seed).standard_normal((count, 128, 128))
    return G @ G.transpose(0, 2, 1) / 128 + 0.5 * np.eye(128)


# -- the spine ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_engine_run():
    """The JAX package's blocked engine in float32 on one panel (N = 100
    pads to 128), its Pallas spine in interpret mode, over 4 chains; the
    spine call is recorded.  The engine pads the chains to 128 lanes; the
    recorder makes one padding lane's block non positive definite on its
    way in (a negative entry at pivot 64), so the recorded call also holds
    a failed factorization, and the engine drops that lane's results."""
    x, y, yerr = _dataset(100, seed=11)
    gj, gt = _pair(_config5, seed=11)
    active = (0, 1, 2, 3, 4)
    calls = []
    inner = jdm._spine

    def recorder(K_l, interpret=False):
        K_l = K_l.at[64, 64, NON_PD_LANE].set(-1.0)
        out = inner(K_l, interpret=interpret)
        calls.append((np.asarray(K_l), np.asarray(out[0]),
                      np.asarray(out[1])))
        return out

    jdm._spine = recorder
    try:
        vg_j = jdm.make_dense_mxu_vg(gj.kernel.spec_node(), x, y, yerr ** 2,
                                     1, 1, active, interpret=True)
        thetas = _thetas(gj.get_parameter_vector(include_frozen=True), 4,
                         0.15, seed=12)
        ll_j, g_j = (np.asarray(a) for a in vg_j(jnp.asarray(thetas,
                                                              jnp.float32)))
    finally:
        jdm._spine = inner
    assert len(calls) == 1
    vg_t = dense_mxu.make_dense_mxu_vg(gt.kernel.spec_node(), x, y,
                                       yerr ** 2, 1, 1, active)
    return dict(thetas=thetas, ll=ll_j, g=g_j, vg_t=vg_t, spine=calls[0])


NON_PD_LANE = 100


def test_spine_plain_version_matches_jax_interpret_spine(jax_engine_run):
    K_l, T_j, ld_j = jax_engine_run["spine"]
    S32 = np.ascontiguousarray(np.moveaxis(K_l, -1, 0))    # (128, 128, 128)
    T_j = np.moveaxis(T_j, -1, 0)
    T_t, ld_t = dense_mxu.spine_torch(torch.as_tensor(S32))
    T_t, ld_t = T_t.numpy(), ld_t.numpy()
    assert T_t.dtype == np.float32
    ok = np.ones(S32.shape[0], dtype=bool)
    ok[NON_PD_LANE] = False
    # NaN on the non-PD chain in both (the JAX spine's log and 1/sqrt of
    # a negative pivot), finite elsewhere.
    assert np.isnan(ld_j[NON_PD_LANE]) and np.isnan(ld_t[NON_PD_LANE])
    assert np.all(np.isnan(T_t[NON_PD_LANE]))
    assert np.any(np.isnan(T_j[NON_PD_LANE]))
    assert np.all(np.isfinite(T_t[ok])) and np.all(np.isfinite(ld_t[ok]))
    assert np.all(np.isfinite(T_j[ok])) and np.all(np.isfinite(ld_j[ok]))
    # float32 on both sides, other algorithms (the JAX spine's Neumann 8 x 8
    # inverses and block substitution against cholesky_ex and a triangular
    # solve), each held to the float64 factorization of the same blocks: T
    # within 1e-4 of its largest entry, logdet within 1e-5 relative.
    T64, ld64 = dense_mxu.spine_torch(torch.as_tensor(S32[ok]).double())
    scale = float(T64.abs().max())
    for T, ld in ((T_t[ok], ld_t[ok]), (T_j[ok], ld_j[ok])):
        np.testing.assert_allclose(T, T64.numpy(), rtol=0, atol=1e-4 * scale)
        np.testing.assert_allclose(ld, ld64.numpy(), rtol=1e-5)
    np.testing.assert_allclose(T_t[ok], T_j[ok], rtol=0, atol=2e-4 * scale)
    assert np.all(np.triu(T_t[ok], 1) == 0)


def test_spine_plain_version_is_the_factorization():
    S = torch.as_tensor(_spd_blocks(4, seed=2))
    T, ld = dense_mxu.spine_torch(S)
    eye = torch.eye(128, dtype=S.dtype)
    L = torch.linalg.cholesky(S)
    np.testing.assert_allclose((T @ L).numpy(), eye.expand_as(L).numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(ld.numpy(), torch.logdet(S).numpy(),
                               rtol=1e-12)
    # On the CPU the wrapper is the plain version, and counts no launch.
    launches = dense_mxu.spine.launches
    T2, ld2 = dense_mxu.spine(S)
    assert torch.equal(T2, T) and torch.equal(ld2, ld)
    assert dense_mxu.spine.launches == launches
    with pytest.raises(ValueError):
        dense_mxu.spine(S[:, :64, :64])


# -- the engine against the JAX x64 oracle -------------------------------------

_CASES = {
    # N=200 pads to 256: two panels and every off-diagonal path.
    "two_panels": (_config5, None, 200, 3, 0),
    # The general (Cholesky-parameterised) metric, outside the fused
    # kernel's envelope; one padded panel (dense_mxu_min_n = 0).
    "general_metric": (_general, None, 40, 2, 3),
    # N=300 pads to 384: three panels; a sum with a frozen parameter.
    "three_panels_sum_frozen": (_sum, "kernel:k2:k1:log_constant", 300, 3,
                                5),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_engine_float64_matches_jax_oracle(mxu_on, name):
    kwargs_of, freeze, n, d, seed = _CASES[name]
    tconfig.dense_mxu_min_n = 0
    x, y, yerr = _dataset(n, d=d, seed=seed)
    gj, gt = _pair(kwargs_of, freeze, seed=seed)
    lp_j, theta0 = jax_build(gj, x, y, yerr, method="dense")
    lp_t, theta0_t = torch_build(gt, x, y, yerr, method="dense",
                                 device="cpu")
    assert lp_j.engine == "xla_dense" and lp_t.engine == "torch_dense_mxu"
    np.testing.assert_array_equal(theta0_t.numpy(), np.asarray(theta0))
    if freeze:
        assert len(theta0) == len(gj) and len(theta0) < len(
            gj.get_parameter_vector(include_frozen=True))
    thetas = _thetas(theta0, 3, 0.15, seed=seed + 1)
    ref_lp, ref_g = _jax_vg(lp_j, thetas)
    launches = dense_mxu.spine.launches
    lp, g = lp_t.batched_value_and_grad(torch.as_tensor(thetas))
    assert dense_mxu.spine.launches == launches      # the CPU: no kernel
    np.testing.assert_allclose(lp.numpy(), ref_lp, rtol=RTOL64)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=RTOL64, atol=ATOL64)


def test_engine_bounds_prior_and_rejected_rows(mxu_on):
    x, y, yerr = _dataset(150, seed=7)
    gj, gt = _pair(_bounded)
    lp_j, theta0 = jax_build(gj, x, y, yerr, method="dense",
                             log_prior=lambda th: -0.5 * jnp.sum(th ** 2))
    lp_t, _ = torch_build(gt, x, y, yerr, method="dense", device="cpu",
                          log_prior=lambda th: -0.5 * torch.sum(th ** 2))
    assert lp_t.engine == "torch_dense_mxu"
    thetas = np.stack([np.asarray(theta0)] * 3)
    thetas[1, -1] = 5.0                          # out of bounds
    thetas[2, 0] = 1000.0                        # exp overflows: not PD
    ref_lp, ref_g = _jax_vg(lp_j, thetas)
    lp, g = lp_t.batched_value_and_grad(torch.as_tensor(thetas))
    np.testing.assert_allclose(lp[0].item(), ref_lp[0], rtol=RTOL64)
    np.testing.assert_allclose(g[0].numpy(), ref_g[0], rtol=RTOL64,
                               atol=ATOL64)
    assert lp[1] == lp[2] == ref_lp[1] == ref_lp[2] == -np.inf
    # Rejected points: the gradient is the prior's alone (exactly -theta).
    np.testing.assert_array_equal(g[1:].numpy(), -thetas[1:])
    # The engine itself reports the failed factorization as NaN.
    full = np.stack([gt.get_parameter_vector(include_frozen=True)] * 2)
    full[1, 2] = 1000.0                          # the log amplitude
    ll, grad = lp_t.dense_mxu_vg(torch.as_tensor(full))
    assert np.isfinite(ll[0].item()) and np.isnan(ll[1].item())
    assert torch.all(torch.isnan(grad[1]))


def test_engine_float32_matches_jax_engine(jax_engine_run):
    run = jax_engine_run
    vg_t = run["vg_t"]
    ll_t, g_t = vg_t(torch.as_tensor(run["thetas"], dtype=torch.float32))
    assert ll_t.dtype == g_t.dtype == torch.float32
    # tests/test_dense_mxu.py's tolerances for the JAX engine.
    np.testing.assert_allclose(ll_t.numpy(), run["ll"], rtol=1e-4, atol=5e-2)
    np.testing.assert_allclose(g_t.numpy(), run["g"], rtol=1e-3, atol=5e-2)
    # And the float32 engine against its own float64 run, at the
    # reference's float32 kernel tolerances.
    ll64, g64 = vg_t(torch.as_tensor(run["thetas"]))
    np.testing.assert_allclose(ll_t.double().numpy(), ll64.numpy(),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(g_t.double().numpy(), g64.numpy(),
                               rtol=1e-3, atol=1e-2)


def test_engine_scopes_full_precision_matmul():
    x, y, yerr = _dataset(130, seed=13)
    gt = george_tpu_torch.GP(device="cpu", **_config5(tk))
    vg = dense_mxu.make_dense_mxu_vg(gt.kernel.spec_node(), x, y, yerr ** 2,
                                     1, 1, (0, 1, 2, 3, 4))
    theta = torch.as_tensor(_thetas(gt.get_parameter_vector(), 2, 0.1, 14))
    m = torch.backends.cuda.matmul
    seen = []
    saved = m.allow_tf32
    m.allow_tf32 = True
    try:
        vg.value_and_grad(theta, stage=lambda name: seen.append(
            (name, m.allow_tf32)))
        after = m.allow_tf32
    finally:
        m.allow_tf32 = saved
    assert seen == [(s, False) for s in ("build", "factor", "inverse", "ll",
                                         "grad")]
    assert after is True


# -- routing -----------------------------------------------------------------

def test_routing_thresholds(mxu_on):
    # tests/test_dense_mxu.py's routing, with the port's engine names: with
    # dense_mxu_sampling on, <= 128 and metric 0/1 take the fused engine,
    # 129..512 the blocked engine, > 512 the plain density.
    gt = george_tpu_torch.GP(device="cpu", **_config5(tk))
    for n, engine in ((40, "torch_dense"), (140, "torch_dense_mxu"),
                      (dense_mxu.MXU_MAX_N, "torch_dense_mxu"),
                      (dense_mxu.MXU_MAX_N + 8, "torch_dense_autograd")):
        x, y, yerr = _dataset(n)
        lp, _ = torch_build(gt, x, y, yerr, method="dense", device="cpu")
        assert lp.engine == engine, (n, lp.engine)
    # The general metric is outside the fused envelope: the blocked engine
    # at any N up to 512, dense_mxu_min_n or not.
    gg = george_tpu_torch.GP(device="cpu", **_general(tk))
    for n, engine in ((140, "torch_dense_mxu"), (40, "torch_dense_mxu")):
        x, y, yerr = _dataset(n, d=2)
        lp, _ = torch_build(gg, x, y, yerr, method="dense", device="cpu")
        assert lp.engine == engine, (n, lp.engine)
    # The default (dense_mxu_sampling off): the fused engine over its whole
    # envelope (N <= 256), the plain density beyond; never the blocked one.
    tconfig.dense_mxu_sampling = False
    for n, engine in ((140, "torch_dense"), (300, "torch_dense_autograd")):
        x, y, yerr = _dataset(n)
        lp, _ = torch_build(gt, x, y, yerr, method="dense", device="cpu")
        assert lp.engine == engine, (n, lp.engine)
    assert jconfig.dense_mxu_sampling is False


# -- the batched product -----------------------------------------------------

def test_batched_mmT_plain_version_matches_jax_einsum():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 128, 128))
    b = rng.standard_normal((8, 128, 128))
    ref = np.asarray(jnp.einsum("bij,bkj->bik", a, b,
                                precision=jax.lax.Precision.HIGHEST))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    out = batched_mm.batched_mmT_torch(ta, tb)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)
    launches = batched_mm.batched_mmT.launches
    assert torch.equal(batched_mm.batched_mmT(ta, tb), out)
    assert batched_mm.batched_mmT.launches == launches
    with pytest.raises(ValueError):
        batched_mm.batched_mmT(ta, tb[:, :64, :64])


# -- on the card -------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_spine_matches_plain_version():
    dev = _cuda()
    # 301 chains: a count that is no multiple of the chains an SM holds.
    S = _spd_blocks(301, seed=3)
    S[7, 64, 64] = -1.0
    S[8, 0, 0] = 0.0
    S64 = torch.as_tensor(S, device=dev)
    T_ref, ld_ref = dense_mxu.spine_torch(S64)
    launches = dense_mxu.spine.launches
    # Only the lower triangle is read: NaN above it changes nothing.
    upper = torch.ones(128, 128, dtype=torch.bool, device=dev).triu(1)
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-5)):
        Sd = S64.to(dtype).masked_fill(upper, float("nan")).contiguous()
        T, ld = dense_mxu.spine(Sd)
        torch.cuda.synchronize()
        T, ld = T.double(), ld.double()
        bad = torch.isnan(ld_ref)
        assert torch.equal(torch.isnan(ld), bad)
        assert torch.all(torch.isnan(T[bad]))
        scale = float(T_ref[~bad].abs().max())
        assert float((T[~bad] - T_ref[~bad]).abs().max()) <= tol * scale
        assert bool(torch.all((ld[~bad] - ld_ref[~bad]).abs()
                              <= tol * ld_ref[~bad].abs()))
    assert dense_mxu.spine.launches == launches + 2


@pytest.mark.gpu
def test_cuda_batched_mmT_matches_plain_version():
    dev = _cuda()
    rng = np.random.default_rng(4)
    cases = [(64, 128, c) for c in batched_mm.CHAINS_PER_BLOCK]
    for nb, n, c in cases + [(9, 70, 32), (3, 300, 8)]:
        a = torch.as_tensor(rng.standard_normal((nb, n, n)), device=dev)
        b = torch.as_tensor(rng.standard_normal((nb, n, n)), device=dev)
        ref = batched_mm.batched_mmT_torch(a, b)
        bound = torch.linalg.norm(a, dim=2)[:, :, None] \
            * torch.linalg.norm(b, dim=2)[:, None, :]
        for dtype, tol in ((torch.float64, 1e-12),
                           (torch.float32, 16 * 2.0 ** -23)):
            out = batched_mm.batched_mmT(a.to(dtype), b.to(dtype), c)
            torch.cuda.synchronize()
            assert bool(torch.all((out.double() - ref).abs() <= tol * bound))


@pytest.mark.gpu
def test_cuda_engine_matches_plain_spine(mxu_on):
    dev = _cuda()
    x, y, yerr = _dataset(300, seed=5)
    gt = george_tpu_torch.GP(device=dev, **_sum(tk))
    lp, theta0 = torch_build(gt, x, y, yerr, method="dense", device=dev)
    assert lp.engine == "cuda_dense_mxu"
    vg = lp.dense_mxu_vg
    theta = torch.as_tensor(_thetas(gt.get_parameter_vector(
        include_frozen=True), 64, 0.1, 6), device=dev)
    ll_ref, g_ref = vg.value_and_grad(theta, spine_fn=dense_mxu.spine_torch)
    launches = dense_mxu.spine.launches
    ll, g = vg(theta)
    torch.cuda.synchronize()
    assert dense_mxu.spine.launches == launches + 3
    assert bool(torch.all((ll - ll_ref).abs() <= 1e-9 * ll_ref.abs()))
    assert bool(torch.all((g - g_ref).abs() <= 1e-9 * g_ref.abs() + 1e-9))
