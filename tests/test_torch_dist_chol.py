# -*- coding: utf-8 -*-
"""The port's distributed blocked Cholesky (``parallel/dist_chol.py``)
against the JAX package's on a 2-device mesh.

Two gloo ranks on the CPU in float64 (one spawn, a module fixture, with a
``file://`` rendezvous under ``tmp_path``); the rank workers import no JAX.
The JAX functions run in the test process under ``shard_map`` over two of
the virtual CPU devices of tests/conftest.py, jitted.  At most four test
functions.
"""

import datetime
import logging
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)

RTOL = 1e-10
P = 2
BLOCK = 16
CHOL_N = (64, 50)           # 2 panels a rank; padded from 50
SOLVE_N = 64
LL_N = 2 * 16 * 4           # 4 panels a rank
PAD_N, PAD_BLOCK = 300, 32  # pads to 320


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def gp_data(n, seed):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    yerr = 0.1 * np.ones(n)
    y = np.sin(x) + yerr * rng.standard_normal(n)
    return x, y, yerr


def torch_gp(constant=1.5, scale=0.9):
    import george_tpu_torch
    from george_tpu_torch import kernels

    return george_tpu_torch.GP(constant * kernels.Matern32Kernel(scale),
                               white_noise=np.log(1e-3),
                               fit_white_noise=True, device="cpu")


# -- what the ranks run (no JAX) ---------------------------------------------

def _work():
    from george_tpu_torch.parallel import (
        chain_mesh, make_sharded_gp_log_prob_factory)
    from george_tpu_torch.parallel import dist_chol
    from george_tpu_torch.parallel.mesh import shard

    mesh = chain_mesh(axis="data", device="cpu")
    axis = mesh.axis("data")
    out = {"chol": [dist_chol.distributed_cholesky(
        torch.as_tensor(_spd(n, n)), mesh, block_size=BLOCK) for n in CHOL_N]}

    K = torch.as_tensor(_spd(SOLVE_N, 2))
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(SOLVE_N))
    L_local, logdet = dist_chol.cholesky_local(shard(K, axis), axis, BLOCK)
    out["solve"] = (dist_chol.solve_local(L_local, b, axis, BLOCK), logdet)

    gp = torch_gp()
    x, y, yerr = gp_data(LL_N, 11)
    factory, data = make_sharded_gp_log_prob_factory(
        gp, x, y, yerr, distributed_cholesky=True, block_size=BLOCK,
        device="cpu")
    lp = factory(*(shard(torch.as_tensor(d), axis) for d in data))
    theta = torch.as_tensor(gp.get_parameter_vector()).requires_grad_(True)
    val = lp(theta)
    out["loglike"] = (lp.engine, val.detach(),
                      torch.autograd.grad(val, theta)[0])

    gp = torch_gp(1.0, 1.0)
    x, y, yerr = gp_data(PAD_N, 3)
    factory, data = make_sharded_gp_log_prob_factory(
        gp, x, y, yerr, distributed_cholesky=True, block_size=PAD_BLOCK,
        mesh=mesh)
    lp = factory(*(shard(torch.as_tensor(d), axis) for d in data))
    out["padded"] = (data[0].shape[0], lp.engine,
                     lp(torch.as_tensor(gp.get_parameter_vector())))
    return out


def _rank(rank, root):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        root, "rendezvous"), rank=rank, world_size=P,
        timeout=datetime.timedelta(seconds=120))
    try:
        torch.save(_work(), os.path.join(root, "rank{0}.pt".format(rank)))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist_chol"))
    mp.spawn(_rank, args=(root,), nprocs=P, join=True)
    return [torch.load(os.path.join(root, "rank{0}.pt".format(r)),
                       weights_only=False) for r in range(P)]


# -- the test process: the JAX package's functions ----------------------------

def _mesh():
    from george_tpu.parallel import chain_mesh

    return chain_mesh(P, axis="data")


def _close(mine, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(mine), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max(), err_msg=what)


def test_distributed_cholesky_matches_jax(ranks):
    """Padded (N = 50) and unpadded (N = 64): the factor gathered on every
    rank and the log-determinant equal the JAX function's."""
    from george_tpu.parallel.dist_chol import distributed_cholesky

    for i, n in enumerate(CHOL_N):
        L_ref, logdet_ref = distributed_cholesky(_spd(n, n), _mesh(),
                                                 block_size=BLOCK)
        for rank in ranks:
            L, logdet = rank["chol"][i]
            assert L.shape == (n, n)
            _close(L.numpy(), L_ref, "L, N={0}".format(n))
            _close(float(logdet), float(logdet_ref), "logdet N={0}".format(n))


def test_solve_local_matches_jax(ranks):
    """``cholesky_local`` + ``solve_local`` on each rank's stripe against
    the JAX functions under ``shard_map``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Spec
    from george_tpu.parallel.dist_chol import cholesky_local, solve_local

    def run(K, b):
        L_loc, logdet = cholesky_local(K, "data", block_size=BLOCK)
        x = solve_local(L_loc, b, "data", block_size=BLOCK)
        return jax.lax.pmean((x, logdet), "data")

    fn = jax.jit(jax.shard_map(run, mesh=_mesh(),
                               in_specs=(Spec("data", None), Spec()),
                               out_specs=(Spec(), Spec())))
    b = np.random.default_rng(3).standard_normal(SOLVE_N)
    x_ref, logdet_ref = fn(jnp.asarray(_spd(SOLVE_N, 2)), jnp.asarray(b))
    for rank in ranks:
        x, logdet = rank["solve"]
        _close(x.numpy(), x_ref, "solve_local")
        _close(float(logdet), float(logdet_ref), "cholesky_local logdet")


def test_distributed_loglike_value_and_gradient_match_jax(ranks):
    """The fully distributed likelihood (``distributed_loglike_fn`` through
    the factory): value and gradient on every rank equal the JAX package's
    sharded program and its ``jax.grad``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Spec
    import george_tpu
    from george_tpu import kernels as jk
    from george_tpu.parallel.sharded import make_sharded_gp_log_prob_factory

    jgp = george_tpu.GP(1.5 * jk.Matern32Kernel(0.9),
                        white_noise=np.log(1e-3), fit_white_noise=True)
    x, y, yerr = gp_data(LL_N, 11)
    factory, data = make_sharded_gp_log_prob_factory(
        jgp, x, y, yerr, distributed_cholesky=True, block_size=BLOCK)

    def run(theta, *local):
        return jax.value_and_grad(factory(*local))(theta)

    fn = jax.jit(jax.shard_map(
        run, mesh=_mesh(),
        in_specs=(Spec(),) + tuple(Spec("data") for _ in data),
        out_specs=(Spec(), Spec())))
    v_ref, g_ref = fn(jnp.asarray(jgp.get_parameter_vector()),
                      *[jnp.asarray(d) for d in data])
    for rank in ranks:
        engine, val, grad = rank["loglike"]
        assert engine == "dist_chol"
        _close(float(val), float(v_ref), "value")
        _close(grad.numpy(), g_ref, "gradient")


def test_factory_auto_padding_and_routing(ranks, caplog):
    """The factory pads N = 300 to a multiple of P * block_size (320) and
    the padding contributes nothing (the JAX GP's log-likelihood); "auto"
    takes the distributed Cholesky from N = 8192 with a mesh, stays
    replicated (with the engine note) without one, and below 8192; the
    factory wants the card unless given ``device="cpu"``."""
    import george_tpu
    from george_tpu import kernels as jk
    from george_tpu_torch.parallel import make_sharded_gp_log_prob_factory
    from george_tpu_torch.parallel.mesh import Axis, Mesh

    jgp = george_tpu.GP(1.0 * jk.Matern32Kernel(1.0),
                        white_noise=np.log(1e-3), fit_white_noise=True)
    x, y, yerr = gp_data(PAD_N, 3)
    jgp.compute(x, yerr)
    ll_ref = float(jgp.log_likelihood(y))
    for rank in ranks:
        n_total, engine, ll = rank["padded"]
        assert n_total == 320 and engine == "dist_chol"
        np.testing.assert_allclose(float(ll), ll_ref, rtol=RTOL)

    # Routing needs no process group until a log-prob is evaluated.
    mesh = Mesh([Axis("data", P, 0, None)], torch.device("cpu"))
    engines = {}
    for n, with_mesh in ((8192, True), (8192, False), (8191, True)):
        x, y, yerr = gp_data(n, 5)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="george_tpu_torch"):
            factory, data = make_sharded_gp_log_prob_factory(
                torch_gp(), x, y, yerr,
                mesh=mesh if with_mesh else None, device="cpu")
        engines[(n, with_mesh)] = (factory(*data).engine, data[0].shape[0],
                                   len(caplog.records))
    assert engines[(8192, True)] == ("dist_chol", 8192, 0)
    assert engines[(8192, False)] == ("sharded_replicated_chol", 8192, 1)
    assert engines[(8191, True)] == ("sharded_replicated_chol", 8191, 0)
    if not torch.cuda.is_available():
        # The entry point runs on the card unless given device="cpu".
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_sharded_gp_log_prob_factory(torch_gp(), x, y, yerr)
