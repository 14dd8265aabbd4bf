# -*- coding: utf-8 -*-
"""The port's tempered SMC against the JAX package's.

``run_smc`` is replayed on the JAX package's key stream: the port's
randomness seam (a stream with ``stage_draws``) is filled with the numbers
that ``george_tpu/samplers/smc.py`` draws, split in its order (a stage's
resampling uniform, then each mutation's normals and accept uniforms), so
the resampling, every accept decision and the temperature schedule must
be the same.  The target is a small dense GP posterior (float64 on both
sides: the port on the CPU with its plain dense value+gradient, JAX on the
CPU in x64, as tests/conftest.py sets it).  Each stage's incremental log
weights, (lambda_new - lambda) x (log target - log init) at every
particle, are recorded on both sides through the module-level
``_systematic_resample`` (a runtime patch), which holds the lambda
schedule to JAX's stage by stage.

At most four test functions (``--dist loadfile`` queues the files with
fewer tests last).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import george_tpu
from george_tpu import kernels as jk
from george_tpu.samplers import build_gp_log_prob as jax_build
from george_tpu.samplers import smc as jsmc

import george_tpu_torch
from george_tpu_torch import kernels as tk
from george_tpu_torch.samplers import build_gp_log_prob as torch_build
from george_tpu_torch.samplers import smc as tsmc

torch.set_num_threads(1)

RTOL = 1e-9
PARTICLES = 64
STAGES = 3
INIT_SCALE = np.array([0.6, 0.5, 0.8])


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _close(mine, ref, what, rtol=RTOL):
    ref = np.asarray(ref, dtype=np.float64)
    np.testing.assert_allclose(
        np.asarray(mine, dtype=np.float64), ref, rtol=rtol,
        atol=rtol * max(np.abs(ref[np.isfinite(ref)]).max(initial=0.0),
                        1e-300), err_msg=what)


def _data(n=24, seed=5):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 8, n))
    yerr = 0.2 * np.ones(n)
    y = np.sin(2 * np.pi * x / 2.3) + yerr * rng.standard_normal(n)
    return x, y, yerr


def _posteriors():
    x, y, yerr = _data()
    jgp = george_tpu.GP(1.0 * jk.ExpSquaredKernel(1.0),
                        white_noise=np.log(1e-2), fit_white_noise=True)
    tgp = george_tpu_torch.GP(1.0 * tk.ExpSquaredKernel(1.0),
                              white_noise=np.log(1e-2), fit_white_noise=True,
                              device="cpu")
    jlp, theta0 = jax_build(jgp, x, y, yerr, method="dense")
    tlp, _ = torch_build(tgp, x, y, yerr, method="dense", device="cpu")
    assert tlp.engine == "torch_dense"
    return jlp, tlp, np.asarray(theta0)


def _log_inits(theta0):
    mu, scale = theta0, INIT_SCALE
    const = -np.sum(np.log(scale)) - 0.5 * len(mu) * np.log(2 * np.pi)

    def jax_init(z):
        d = (z - mu) / scale
        return -0.5 * jnp.sum(d * d) + const

    def torch_init(z):
        d = (z - _t(mu)) / _t(scale)
        return -0.5 * torch.sum(d * d, dim=-1) + const

    return jax_init, torch_init


class JaxStream(object):
    """The port's SMC randomness from the JAX package's key stream, split
    as its ``run_smc`` splits it a stage."""

    def __init__(self, key):
        self.key = key

    def stage_draws(self, n, dim, num_mutations, dtype, device):
        self.key, key_rs, key_mut = jax.random.split(self.key, 3)
        eps, acc = [], []
        for key_t in jax.random.split(key_mut, num_mutations):
            key_p, key_u = jax.random.split(key_t)
            eps.append(jax.random.normal(key_p, (n, dim), jnp.float64))
            acc.append(jax.random.uniform(key_u, (n,), jnp.float64))
        return (_t(jax.random.uniform(key_rs)), _t(np.stack(eps)),
                _t(np.stack(acc)))


def _recording(module, monkeypatch, in_jax):
    """Patch ``module._systematic_resample`` to record each stage's log
    weights (through a debug callback inside the JAX package's jit)."""
    seen = []
    original = module._systematic_resample

    if in_jax:
        def patched(key, log_weights, axis_name=None):
            jax.debug.callback(lambda w: seen.append(np.asarray(w)),
                               log_weights, ordered=True)
            return original(key, log_weights, axis_name)
    else:
        def patched(u, log_weights):
            seen.append(log_weights.numpy().copy())
            return original(u, log_weights)

    monkeypatch.setattr(module, "_systematic_resample", patched)
    return seen


def test_systematic_resample_same_draw():
    rng = np.random.default_rng(3)
    for n in (1, 7, 64):
        log_w = rng.standard_normal(n) * 3.0
        log_w[rng.random(n) < 0.2] = -np.inf
        if not np.isfinite(log_w).any():
            log_w[0] = 0.0
        key = jax.random.PRNGKey(n)
        ref = np.asarray(jsmc._systematic_resample(key, jnp.asarray(log_w)))
        mine = tsmc._systematic_resample(_t(jax.random.uniform(key)),
                                         _t(log_w))
        np.testing.assert_array_equal(mine.numpy(), ref)
        _close(tsmc._ess(_t(log_w)), jsmc._ess(jnp.asarray(log_w)),
               "ESS n={0}".format(n))


def _replay(mutation, monkeypatch, **kw):
    jlp, tlp, theta0 = _posteriors()
    jax_init, torch_init = _log_inits(theta0)
    z0 = theta0 + INIT_SCALE * np.random.default_rng(11).standard_normal(
        (PARTICLES, len(theta0)))
    key = jax.random.PRNGKey(4)
    jax_w = _recording(jsmc, monkeypatch, True)
    mine_w = _recording(tsmc, monkeypatch, False)
    ref = jsmc.run_smc(jlp, jax_init, jnp.asarray(z0), key,
                       max_stages=STAGES, mutation=mutation, **kw)
    jax.effects_barrier()
    mine = tsmc.run_smc(tlp, torch_init, _t(z0), JaxStream(key),
                        max_stages=STAGES, mutation=mutation, device="cpu",
                        **kw)
    assert mine.num_stages == int(ref.num_stages) == len(jax_w) \
        == len(mine_w)
    # Each stage's log weights carry its lambda step: equal weights at
    # equal particles, equal steps.
    for s, (a, b) in enumerate(zip(mine_w, jax_w)):
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        _close(a[np.isfinite(a)], b[np.isfinite(b)],
               "stage {0} log weights".format(s))
    steps = np.diff(np.concatenate([[0.0], mine.lambdas.numpy()]))
    assert np.all(steps > 0) and mine.lambdas[-1] <= 1.0
    _close(mine.particles, ref.particles, "particles")
    _close(mine.log_prob, ref.log_prob, "log target at the particles")
    _close(mine.log_evidence, ref.log_evidence, "log Z")
    _close(mine.acceptance, ref.acceptance, "acceptance")
    return mine


def test_smc_random_walk_replays_jax(monkeypatch):
    mine = _replay("rw", monkeypatch, num_mutations=3)
    # One batched evaluation for the initial cloud, one a mutation.
    assert mine.num_evaluations == 1 + STAGES * 3


def test_smc_hmc_replays_jax(monkeypatch):
    mine = _replay("hmc", monkeypatch, num_mutations=2, num_leapfrog=3)
    # The initial cloud, then a stage's carry seed and its leapfrogs.
    assert mine.num_evaluations == 1 + STAGES * (1 + 2 * 3)
