# -*- coding: utf-8 -*-
"""The port's ADVI and checkpoints against the JAX package's.

``run_advi`` is replayed on the JAX package's key stream (the port's
stream seam filled with the standard normals that
``george_tpu/samplers/advi.py`` draws, a key split a step), on the main
path's model at a small N: ``1.0 * Matern32Kernel`` with a fitted log
white noise, whose port density runs the Kalman value+gradient's plain
version on the CPU (on the card, one launch of ``csrc/kalman_vg.cu`` a
step).  The port's Adam is held to optax's, mean-field and full-rank: the
ELBO at every step and the fitted mean and scale after 15 and 30 steps at
rtol 1e-9 (float64 on both sides).  A checkpoint round-trips, and one
written by the JAX package restores in the port.

At most four test functions (``--dist loadfile`` queues the files with
fewer tests last).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import george_tpu
from george_tpu import checkpoint as jckpt
from george_tpu import kernels as jk
from george_tpu.samplers import advi as jadvi
from george_tpu.samplers import build_gp_log_prob as jax_build

import george_tpu_torch
from george_tpu_torch import checkpoint as tckpt
from george_tpu_torch import kernels as tk
from george_tpu_torch.samplers import advi as tadvi
from george_tpu_torch.samplers import build_gp_log_prob as torch_build
from george_tpu_torch.samplers import hmc as thmc

torch.set_num_threads(1)

RTOL = 1e-9
NUM_MC = 6


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _close(mine, ref, what, rtol=RTOL):
    ref = np.asarray(ref, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(mine, dtype=np.float64), ref,
                               rtol=rtol, atol=rtol * np.abs(ref).max(),
                               err_msg=what)


def _posteriors(n=24, seed=3):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    yerr = 0.1 * np.ones(n)
    y = np.sin(x) + yerr * rng.standard_normal(n)
    jgp = george_tpu.GP(1.0 * jk.Matern32Kernel(1.0),
                        white_noise=np.log(1e-2), fit_white_noise=True)
    tgp = george_tpu_torch.GP(1.0 * tk.Matern32Kernel(1.0),
                              white_noise=np.log(1e-2), fit_white_noise=True,
                              device="cpu")
    jlp, theta0 = jax_build(jgp, x, y, yerr)
    tlp, _ = torch_build(tgp, x, y, yerr, device="cpu")
    assert tlp.engine == "torch_kalman"
    return jlp, tlp, np.asarray(theta0)


class JaxNormals(object):
    """The port's ADVI normals from the JAX package's key stream."""

    def __init__(self, key):
        self.key = key

    def normal(self, shape, dtype, device):
        self.key, sub = jax.random.split(self.key)
        return _t(jax.random.normal(sub, shape, jnp.float64))


def _advi_replays_jax(full_rank):
    jlp, tlp, theta0 = _posteriors()
    key = jax.random.PRNGKey(7)
    for steps in (15, 30):
        ref = jadvi.run_advi(jlp, jnp.asarray(theta0), key, num_steps=steps,
                             num_mc=NUM_MC, learning_rate=0.05,
                             full_rank=full_rank)
        mine = tadvi.run_advi(tlp, _t(theta0), JaxNormals(key),
                              num_steps=steps, num_mc=NUM_MC,
                              learning_rate=0.05, full_rank=full_rank,
                              device="cpu")
        what = "{0}, {1} steps".format(
            "full rank" if full_rank else "mean field", steps)
        _close(mine.elbo, ref.elbo, what + ": ELBO trace")
        _close(mine.mean, ref.mean, what + ": mean")
        _close(mine.log_std, ref.log_std, what + ": log std")
        if full_rank:
            _close(mine.scale_tril, ref.scale_tril, what + ": scale_tril")
        else:
            assert mine.scale_tril is None
    assert mine.elbo[-5:].mean() > mine.elbo[:5].mean()
    draws = mine.sample(0, 5)
    assert draws.shape == (5, len(theta0)) and bool(torch.isfinite(draws)
                                                    .all())


def test_advi_mean_field_replays_jax():
    _advi_replays_jax(False)


def test_advi_full_rank_replays_jax():
    _advi_replays_jax(True)


def test_checkpoint_round_trip_and_jax_file(tmp_path):
    rng = np.random.default_rng(0)
    states = thmc.HMCState(_t(rng.standard_normal((4, 3))),
                           _t(rng.standard_normal(4)),
                           _t(rng.standard_normal((4, 3))).float())
    gen = torch.Generator().manual_seed(5)
    state = tckpt.sampler_state(states, gen, _t(0.25), _t([1.0, 2.0, 0.5]),
                                extra={"step": 7})
    path = tckpt.save_checkpoint(str(tmp_path / "state"), state)
    assert path.endswith("state.pkl")
    back = tckpt.restore_checkpoint(str(tmp_path / "state"), device="cpu")
    for a, b in zip(back["chain_states"], states):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert torch.equal(back["key"], gen.get_state())
    assert int(back["step"]) == 7
    # A prototype puts the leaves back into its containers.
    proto = {"chain_states": states, "inv_mass": 0, "key": 0,
             "step": 0, "step_size": 0}
    typed = tckpt.restore_checkpoint(path, target=proto)
    assert isinstance(typed["chain_states"], thmc.HMCState)
    assert torch.equal(typed["chain_states"].grad, states.grad)

    # A checkpoint the JAX package wrote.
    z = rng.standard_normal((4, 3))
    key = jax.random.PRNGKey(3)
    jpath = jckpt.save_checkpoint(
        str(tmp_path / "jax.pkl"),
        jckpt.sampler_state({"z": jnp.asarray(z)}, key, jnp.asarray(0.5),
                            jnp.ones(3)))
    got = tckpt.restore_checkpoint(jpath, device="cpu")
    np.testing.assert_array_equal(got["chain_states"]["z"].numpy(), z)
    np.testing.assert_array_equal(got["key"].numpy(), np.asarray(key))
    assert float(got["step_size"]) == 0.5
    assert torch.equal(got["inv_mass"], torch.ones(3, dtype=got[
        "inv_mass"].dtype))
