# -*- coding: utf-8 -*-
"""The port's NUTS and HMC against the JAX package.

The transitions are held to the JAX package's exactly: the port's randomness
seam (``george_tpu_torch.samplers.nuts``: a source with ``momentum`` and
``leaf``) replays the numbers that the JAX package's per-chain key streams
give, split in ``george_tpu/samplers/nuts.py``'s order, so every trajectory
decision must be the same and the states agree to 1e-10 (float64 on both:
the port on the CPU, JAX on the CPU in x64 as tests/conftest.py sets it).
The end-to-end runs draw different random numbers in the two packages, so
they agree in distribution only.  No JAX NUTS chain runs here at size:
each JAX transition function is jitted once a configuration.

The checks sit in four test functions: pytest-xdist's ``--dist
loadfile`` hands out the files with more tests first, and this one is to
come after ``tests/test_pallas_dense.py`` and ``tests/test_dense_mxu.py``,
whose long tests must start early for the whole suite to end within its
time limit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import george_tpu
from george_tpu import kernels as jk
from george_tpu.samplers import build_gp_log_prob as jax_build
from george_tpu.samplers import diagnostics as jdiag
from george_tpu.samplers import hmc as jhmc
from george_tpu.samplers import nuts as jnuts

import george_tpu_torch
from george_tpu_torch import kernels as tk
from george_tpu_torch.samplers import build_gp_log_prob as torch_build
from george_tpu_torch.samplers import diagnostics as tdiag
from george_tpu_torch.samplers import hmc as thmc
from george_tpu_torch.samplers import nuts as tnuts
from george_tpu_torch.samplers import run_mcmc as torch_run

# One intra-op thread: the tensors here are small, and the suite's workers
# run side by side (several threads each cost more than they gain).
torch.set_num_threads(1)

RTOL = 1e-10
DIM = 3
CHAINS = 4
# A correlated 3-D Gaussian target.
COV = np.array([[1.0, 0.6, 0.2], [0.6, 2.0, -0.4], [0.2, -0.4, 0.5]])
PREC = np.linalg.inv(COV)
INV_MASS = {
    "diag": np.array([1.0, 1.8, 0.6]),
    "dense": 0.9 * COV + 0.05 * np.eye(DIM),
}


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _close(mine, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(mine), np.asarray(ref), rtol=rtol,
                               atol=atol)


def jax_vg(z):
    g = -(jnp.asarray(PREC) @ z)
    return 0.5 * jnp.dot(z, g), g


def torch_vg(z):
    g = -(z @ _t(PREC))
    return 0.5 * torch.sum(z * g, dim=-1), g


def _start(seed):
    z = np.random.default_rng(seed).standard_normal((CHAINS, DIM)) * 1.5
    logp, grad = torch_vg(_t(z))
    return (thmc.HMCState(_t(z), logp, grad),
            jhmc.HMCState(jnp.asarray(z), jnp.asarray(logp.numpy()),
                          jnp.asarray(grad.numpy())))


def _keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), CHAINS)


@jax.jit
def _momentum_draw(key):
    key, key_r = jax.random.split(key)
    return key, jax.random.normal(key_r, (DIM,), jnp.float64)


@jax.jit
def _leaf_draw(key):
    key, key_dir, key_mn, key_acc = jax.random.split(key, 4)
    return (key, jax.random.bernoulli(key_dir),
            jax.random.uniform(key_mn, dtype=jnp.float64),
            jax.random.uniform(key_acc, dtype=jnp.float64))


class JaxKeys(object):
    """The port's randomness source fed from per-chain JAX keys: a chain's
    key advances only when its row is asked for, as a chain's key does in
    the JAX package's vmapped loops."""

    def __init__(self, keys):
        self.keys = list(keys)

    def _rows(self, mask):
        return np.flatnonzero(mask.numpy())

    def momentum(self, mask, dim, dtype):
        out = torch.zeros((mask.shape[0], dim), dtype=dtype)
        for c in self._rows(mask):
            self.keys[c], eps = _momentum_draw(self.keys[c])
            out[c] = _t(eps)
        return out

    def leaf(self, mask, dtype):
        n = mask.shape[0]
        bit = torch.zeros(n, dtype=torch.bool)
        u_mn, u_acc = torch.zeros(n, dtype=dtype), torch.zeros(n, dtype=dtype)
        for c in self._rows(mask):
            self.keys[c], b, u1, u2 = _leaf_draw(self.keys[c])
            bit[c], u_mn[c], u_acc[c] = bool(b), float(u1), float(u2)
        return bit, u_mn, u_acc


def _same_state(mine, ref):
    for a, b in zip(mine, ref):
        _close(a, b)


# (inv_mass, step size): max_depth reached at the small step, a dense mass,
# and divergences at the large step.
NUTS_CASES = [("diag", 0.05), ("dense", 0.4), ("diag", 3.5)]


def test_nuts_step_replays_jax():
    for mass, eps in NUTS_CASES:
        _nuts_step_replays_jax(mass, eps)


def _nuts_step_replays_jax(mass, eps):
    max_depth = 5
    inv_mass = INV_MASS[mass]
    step = jax.jit(jax.vmap(lambda k, s: jnuts.nuts_step(
        k, s, jax_vg, eps, jnp.asarray(inv_mass), max_depth=max_depth)))
    mine, ref = _start(0)
    for t in range(2):
        keys = _keys(10 + t)
        ref, ref_info = step(keys, ref)
        mine, info = tnuts.nuts_step(JaxKeys(keys), mine, torch_vg, eps,
                                     _t(inv_mass), max_depth=max_depth)
        for field in ("n_leapfrog", "depth", "diverging"):
            np.testing.assert_array_equal(getattr(info, field).numpy(),
                                          np.asarray(getattr(ref_info, field)))
        _close(info.accept_prob, ref_info.accept_prob)
        _close(info.energy, ref_info.energy)
        _same_state(mine, ref)
    if eps == 0.05:
        assert int(info.depth.max()) == max_depth
    if eps == 3.5:
        assert bool(info.diverging.any())


def test_persistent_leapfrog_and_hmc_replay_jax():
    _nuts_draws_persistent_replays_jax()
    for mass in ("diag", "dense"):
        _leapfrog_and_hmc_step(INV_MASS[mass])


def _nuts_draws_persistent_replays_jax():
    max_depth, draws, eps = 4, 6, 0.5
    inv_mass = INV_MASS["diag"]
    run = jax.jit(lambda k, s: jnuts.nuts_draws_persistent(
        k, s, jax_vg, eps, jnp.asarray(inv_mass), draws,
        max_depth=max_depth))
    mine0, ref0 = _start(1)
    keys = _keys(20)
    ref, ref_keys, ref_outs = run(keys, ref0)

    source = JaxKeys(keys)
    mine, outs = tnuts.nuts_draws_persistent(source, mine0, torch_vg, eps,
                                             _t(inv_mass), draws,
                                             max_depth=max_depth)
    for name, a, b in zip(("z", "logp", "accept", "diverging", "n_leapfrog"),
                          outs, ref_outs):
        if name in ("diverging", "n_leapfrog"):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b)
    _same_state(mine, ref)
    # Chains frozen at their quota drew nothing: every chain's key is where
    # the JAX package's loop left it.
    np.testing.assert_array_equal(np.stack(source.keys), np.asarray(ref_keys))
    assert len(set(outs[4].flatten().tolist())) > 2

    # Two continued blocks of 3 draws give the one block's 6.
    source = JaxKeys(keys)
    state, halves = mine0, []
    for _ in range(2):
        state, part = tnuts.nuts_draws_persistent(
            source, state, torch_vg, eps, _t(inv_mass), draws // 2,
            max_depth=max_depth)
        halves.append(part)
    for a, (b, c) in zip(outs, zip(*halves)):
        np.testing.assert_array_equal(a.numpy(), torch.cat([b, c], 1).numpy())
    _same_state(state, mine)


def _leapfrog_and_hmc_step(inv_mass):
    mine, ref = _start(2)
    r = np.random.default_rng(3).standard_normal((CHAINS, DIM))
    ref_lf, ref_r = jax.jit(jax.vmap(lambda s, r: jhmc.leapfrog(
        jax_vg, s, r, 0.3, jnp.asarray(inv_mass), 7)))(ref, jnp.asarray(r))
    lf, r1 = thmc.leapfrog(torch_vg, mine, _t(r), 0.3, _t(inv_mass), 7)
    for a, b in zip(tuple(lf) + (r1,), tuple(ref_lf) + (ref_r,)):
        _close(a, b, rtol=1e-12)

    # hmc_step with the momentum and the accept uniform JAX draws.
    keys = _keys(30)
    eps, u = [], []
    for k in keys:
        k_r, k_u = jax.random.split(k)
        eps.append(np.asarray(jax.random.normal(k_r, (DIM,), jnp.float64)))
        u.append(float(jax.random.uniform(k_u, dtype=jnp.float64)))
    ref_new, ref_info = jax.jit(jax.vmap(lambda k, s: jhmc.hmc_step(
        k, s, jax_vg, 0.9, jnp.asarray(inv_mass), 5)))(keys, ref)
    new, info = thmc.hmc_step(None, mine, torch_vg, 0.9, _t(inv_mass), 5,
                              eps=_t(np.stack(eps)), u=_t(u))
    np.testing.assert_array_equal(info.accepted.numpy(),
                                  np.asarray(ref_info.accepted))
    np.testing.assert_array_equal(info.diverging.numpy(),
                                  np.asarray(ref_info.diverging))
    _close(info.accept_prob, ref_info.accept_prob)
    _same_state(new, ref_new)


def _dataset(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    yerr = 0.1 * np.ones(n)
    y = np.sin(x) + yerr * rng.standard_normal(n)
    return x, y, yerr


GP_DEPTH = 2


@pytest.fixture(scope="module")
def gp_posterior():
    """tests/test_torch_samplers.py's ChEES case (16 chains, the same data
    and start) at N = 16: the plain Kalman value+gradient takes ~35 ms a
    call at N = 32 on a CPU, and each run makes some 250 calls.  The
    reference is the JAX package's posterior mean, its density integrated
    on a grid (one jitted batched call; a JAX NUTS run would spend ~10 s
    compiling)."""
    x, y, yerr = _dataset(n=16)
    gj = george_tpu.GP(1.0 * jk.Matern32Kernel(1.0))
    gt = george_tpu_torch.GP(1.0 * tk.Matern32Kernel(1.0), device="cpu")
    lp_j, theta0 = jax_build(gj, x, y, yerr)
    lp_t, _ = torch_build(gt, x, y, yerr, device="cpu")
    assert lp_t.engine == "torch_kalman"
    z0 = np.asarray(theta0) + 0.1 * np.random.default_rng(4) \
        .standard_normal((16, 2))
    # (log amplitude, log metric) on [-4, 8] x [-3, 9]: the mass left at
    # the edges is below 1e-4.
    grid = np.stack(np.meshgrid(np.linspace(-4, 8, 241),
                                np.linspace(-3, 9, 241), indexing="ij"),
                    axis=-1).reshape(-1, 2)
    lp = np.asarray(jax.jit(jax.vmap(lp_j))(jnp.asarray(grid)))
    w = np.exp(lp - lp.max())
    return lp_t, _t(z0), (w[:, None] * grid).sum(0) / w.sum()


def test_run_mcmc_matches_jax_posterior(gp_posterior):
    for algorithm, opts in (("nuts", dict(persistent=True)),
                            ("nuts", dict(persistent=False)),
                            ("hmc", dict(num_leapfrog=3))):
        _run_mcmc_matches(gp_posterior, algorithm, opts)
    _same_seed_same_draws()


def _run_mcmc_matches(gp_posterior, algorithm, opts):
    lp_t, z0, ref_mean = gp_posterior
    calls = []
    res = torch_run(lp_t, z0, 0, algorithm=algorithm, num_warmup=40,
                    num_samples=40, max_depth=GP_DEPTH, block_size=20,
                    progress=lambda *a: calls.append(a), device="cpu",
                    **opts)
    assert calls == [("warmup", 20, 40), ("warmup", 40, 40),
                     ("sampling", 20, 40), ("sampling", 40, 40)]
    assert res.samples.shape == (16, 40, 2)
    assert res.n_leapfrog.shape == (16, 40)
    assert np.all(np.isfinite(res.samples.numpy()))
    # test_chees_posterior_matches_jax's loose MC bound.
    mean = tdiag.summary(res.samples)["mean"].numpy()
    assert np.all(np.abs(mean - ref_mean) < 0.5)
    nleap = res.n_leapfrog.numpy()
    if algorithm == "hmc":
        assert np.all(nleap == 3)
    else:
        assert nleap.min() >= 1 and nleap.max() <= 2 ** GP_DEPTH - 1
    # Every warmup transition takes at least one batched call, and the
    # draws of every chain as many as its leapfrogs.
    assert res.num_evaluations >= 40 + nleap.sum(axis=1).max()


def _same_seed_same_draws():
    x, y, yerr = _dataset(n=8)
    gt = george_tpu_torch.GP(1.0 * tk.Matern32Kernel(1.0), device="cpu")
    lp_t, theta0 = torch_build(gt, x, y, yerr, device="cpu")
    z0 = theta0 + 0.1 * torch.randn(4, 2, generator=torch.Generator()
                                    .manual_seed(0), dtype=theta0.dtype)
    for algorithm in ("nuts", "hmc"):
        a, b = (torch_run(lp_t, z0, 3, algorithm=algorithm, num_warmup=5,
                          num_samples=5, max_depth=2, num_leapfrog=2,
                          block_size=2, device="cpu") for _ in range(2))
        for field in ("samples", "log_prob", "accept_prob", "n_leapfrog"):
            np.testing.assert_array_equal(getattr(a, field).numpy(),
                                          getattr(b, field).numpy())
        assert a.num_evaluations == b.num_evaluations
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            torch_run(lp_t, z0, 0, algorithm="nuts")


def _draws(seed=5, chains=4, draws=51, dim=2):
    rng = np.random.default_rng(seed)
    x = np.zeros((chains, draws, dim))
    noise = rng.standard_normal((chains, draws, dim))
    for t in range(1, draws):
        x[:, t] = np.array([0.3, 0.85]) * x[:, t - 1] + noise[:, t]
    x[1] += 0.4
    x[..., 1] = np.exp(x[..., 1])           # a heavy right tail
    return x


def test_diagnostics():
    x = _draws()
    _close(tdiag.rank_normalize(_t(x)), jdiag.rank_normalize(jnp.asarray(x)),
           rtol=1e-12)
    # The JAX summary's rank-normalized entries are its rank_normalized_rhat
    # and tail_ess (eager JAX: one call of each is seconds).
    ref = jdiag.summary(jnp.asarray(x), rank_normalized=True)
    mine = tdiag.summary(_t(x), rank_normalized=True)
    assert sorted(mine) == sorted(ref)
    for key in ref:
        _close(mine[key], ref[key], rtol=1e-12)
    _close(tdiag.rank_normalized_rhat(_t(x)), ref["rhat"], rtol=1e-12)
    _close(tdiag.tail_ess(_t(x)), ref["ess_tail"], rtol=1e-12)
    _trajectory_health()


def _trajectory_health():
    rng = np.random.default_rng(6)
    healthy = rng.integers(1, 16, (64, 50))
    piled = np.where(rng.uniform(size=(64, 50)) < 0.8,
                     rng.choice([3, 7], (64, 50)), healthy)
    for n, kw in ((healthy, dict(reference=healthy[::-1])),
                  (healthy, dict(expected_mean=8.0)),
                  (piled, dict(reference=healthy)),
                  (piled, dict(expected_mean=8.0)),
                  (piled, {})):
        mine = tdiag.trajectory_health(torch.as_tensor(n), **kw)
        assert mine == jdiag.trajectory_health(n, **kw)
    assert tdiag.trajectory_health(healthy, reference=healthy)["healthy"]
    assert not tdiag.trajectory_health(piled, reference=healthy)["healthy"]
