# -*- coding: utf-8 -*-
"""The port's multi-rank layer (``george_tpu_torch.parallel``) against the
single-process port and the JAX package.

Every check runs gloo ranks on the CPU in float64, spawned with a
``file://`` rendezvous under the test's ``tmp_path`` (one rendezvous a
spawn, so parallel test workers never share one).  The rank workers below
import no JAX: the JAX package's oracles run in the test process, jitted,
on the virtual CPU devices of tests/conftest.py, and what the workers need
of them (random numbers) is handed over as numpy arrays.

The ranks of a file run in one spawn a world size (a module fixture), and
the tests read their results.  At most four test functions.
"""

import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)

RTOL = 1e-10
A_INV = np.linalg.inv(np.array([[2.0, 0.6], [0.6, 1.0]]))
MU = np.array([1.0, -2.0])
SCALE = np.sqrt(np.diag(np.linalg.inv(A_INV)))
# The data-sharded cases: (route, N); N = 128 divides into P * 16-row
# panels for P = 2 and 4, N = 100 is padded by the factory (mesh given).
DATA_CASES = (("replicated", 64), ("dist", 128), ("dist_padded", 100))
BLOCK = 16
SMC_STAGES = 4
SAMPLER_RUNS = (("chees", dict(num_warmup=200, num_samples=200)),
                ("hmc", dict(num_warmup=150, num_samples=150,
                             num_leapfrog=6)))


# -- what the ranks run (no JAX) ---------------------------------------------

def gaussian_log_prob(z):
    d = z - torch.as_tensor(MU)
    return -0.5 * torch.sum((d @ torch.as_tensor(A_INV)) * d, dim=-1)


def smc_target(z):
    return -0.5 * torch.sum((z - 1.0) ** 2, dim=-1) / 0.3 ** 2


def smc_init(z):
    return -0.5 * torch.sum(z ** 2, dim=-1) / 2.0 ** 2


class ReplayStream(object):
    """SMC random numbers handed over as arrays, one stage a call."""

    def __init__(self, stages):
        self.stages = list(stages)

    def stage_draws(self, n, dim, num_mutations, dtype, device):
        u, eps, acc = self.stages.pop(0)
        return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                     for a in (u, eps, acc))


def gp_data(n, seed=7):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    yerr = 0.1 * np.ones(n)
    y = np.sin(x) + yerr * rng.standard_normal(n)
    return x, y, yerr


def torch_gp():
    import george_tpu_torch
    from george_tpu_torch import kernels

    return george_tpu_torch.GP(1.5 * kernels.Matern32Kernel(0.9),
                               white_noise=np.log(1e-3),
                               fit_white_noise=True, device="cpu")


def job_pooling(P, args):
    """Welford: local accumulation + one merge, and the batch update over
    the axis; dual averaging synced every step."""
    from george_tpu_torch.parallel import chain_mesh
    from george_tpu_torch.samplers import adaptation as adapt
    from george_tpu_torch.samplers.mcmc import _sync_da

    axis = chain_mesh(device="cpu").axis("chains")
    zs, accepts = (torch.as_tensor(a) for a in args)
    out = {}
    for dense in (True, False):
        st = adapt.welford_init(3, dense=dense)
        merged = adapt.welford_merge_across(
            adapt.welford_update_batch(st, zs[axis.index]), axis)
        batch = adapt.welford_update_batch(
            adapt.welford_update_batch(st, zs[axis.index], axis),
            zs[axis.index] + 1.0, axis)
        out[dense] = (merged, batch)
    da = adapt.da_init(torch.tensor(0.5, dtype=torch.float64))
    traj = []
    for a in accepts[:, axis.index]:
        da = _sync_da(adapt.da_update(da, a, target=0.8), True, axis)
        traj.append(da.log_step)
    out["da"] = torch.stack(traj)
    return out


def job_samplers(P, args):
    from george_tpu_torch.parallel import chain_mesh, run_mcmc_sharded

    mesh = chain_mesh(device="cpu")
    z0, = args
    out = {}
    for algorithm, kw in SAMPLER_RUNS:
        res = run_mcmc_sharded(gaussian_log_prob, None, torch.as_tensor(z0),
                               3, mesh, algorithm=algorithm, **kw)
        out[algorithm] = res
    return out


def job_mesh_hmc(P, args):
    """Chains on one axis of a 2 x 2 mesh, the covariance build
    data-sharded on the other (tests/test_parallel.py's
    test_chains_by_data_hmc)."""
    from george_tpu_torch.parallel import (
        chain_data_mesh, make_sharded_gp_log_prob_factory, run_mcmc_sharded)

    z0, = args
    mesh = chain_data_mesh(2, 2, device="cpu")
    x, y, yerr = gp_data(64)
    factory, data = make_sharded_gp_log_prob_factory(torch_gp(), x, y, yerr,
                                                     mesh=mesh)
    return run_mcmc_sharded(factory, data, torch.as_tensor(z0), 3, mesh,
                            data_axis="data", algorithm="hmc",
                            num_leapfrog=8, step_size=0.05, num_warmup=20,
                            num_samples=20)


def job_data(P, args):
    """The data-sharded log-prob's value and gradient at a batch of
    parameter vectors, on each route."""
    from george_tpu_torch.parallel import (
        chain_mesh, make_sharded_gp_log_prob_factory)
    from george_tpu_torch.parallel.mesh import shard

    thetas, = args
    mesh = chain_mesh(axis="data", device="cpu")
    axis = mesh.axis("data")
    out = {}
    for route, n in DATA_CASES:
        x, y, yerr = gp_data(n)
        factory, data = make_sharded_gp_log_prob_factory(
            torch_gp(), x, y, yerr, distributed_cholesky=route != "replicated",
            block_size=BLOCK, mesh=mesh)
        lp = factory(*(shard(torch.as_tensor(d), axis) for d in data))
        th = torch.as_tensor(thetas).requires_grad_(True)
        val = lp(th)
        grad, = torch.autograd.grad(val.sum(), th)
        single = lp(torch.as_tensor(thetas[0]))
        out[route] = (lp.engine, data[0].shape[0], val.detach(), grad,
                      single.detach())
    return out


def job_smc(P, args):
    from george_tpu_torch.parallel import chain_mesh, run_smc_sharded

    p0, stages = args
    mesh = chain_mesh(axis="particles", device="cpu")
    p0 = torch.as_tensor(p0)
    return {
        "rw": run_smc_sharded(smc_target, smc_init, p0, 3, mesh,
                              num_mutations=3),
        "hmc_jax_stream": run_smc_sharded(
            smc_target, smc_init, p0, ReplayStream(stages), mesh,
            num_mutations=2, num_leapfrog=3, mutation="hmc",
            max_stages=SMC_STAGES),
    }


JOBS = {"pooling": job_pooling, "samplers": job_samplers, "data": job_data,
        "smc": job_smc, "mesh_hmc": job_mesh_hmc}


def _rank(rank, P, root, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        root, "rendezvous"), rank=rank, world_size=P,
        timeout=datetime.timedelta(seconds=120))
    try:
        out = {name: JOBS[name](P, args) for name, args in jobs}
        torch.save(out, os.path.join(root, "rank{0}.pt".format(rank)))
    finally:
        dist.destroy_process_group()


def spawn(tmp_path, worlds):
    """Run each world's jobs ({P: [(name, args)]}) on P gloo ranks, the
    worlds side by side; {P: each rank's results}."""
    contexts = {}
    for P, jobs in worlds.items():
        root = str(tmp_path / "world{0}".format(P))
        os.makedirs(root)
        contexts[P] = (root, mp.start_processes(
            _rank, args=(P, root, jobs), nprocs=P, join=False,
            start_method="spawn"))
    for root, context in contexts.values():
        while not context.join():
            pass
    return {P: [torch.load(os.path.join(root, "rank{0}.pt".format(r)),
                           weights_only=False) for r in range(P)]
            for P, (root, _) in contexts.items()}


# -- the test process: inputs, oracles, checks --------------------------------

def _inputs():
    rng = np.random.default_rng(11)
    return {
        "pooling": (rng.standard_normal((4, 16, 3)),
                    rng.uniform(0.2, 1.0, (25, 4))),
        "samplers": (MU + 0.5 * rng.standard_normal((64, 2)),),
        "p0": 2.0 * rng.standard_normal((64, 2)),
    }


def _jax_smc_stages(key, n, dim, num_mutations, stages):
    """The JAX package's ``run_smc`` stream, split as it splits it a stage
    (tests/test_torch_smc.py's ``JaxStream``)."""
    import jax
    import jax.numpy as jnp

    out = []
    for _ in range(stages):
        key, key_rs, key_mut = jax.random.split(key, 3)
        eps, acc = [], []
        for key_t in jax.random.split(key_mut, num_mutations):
            key_p, key_u = jax.random.split(key_t)
            eps.append(np.asarray(jax.random.normal(key_p, (n, dim),
                                                    jnp.float64)))
            acc.append(np.asarray(jax.random.uniform(key_u, (n,),
                                                     jnp.float64)))
        out.append((np.asarray(jax.random.uniform(key_rs)), np.stack(eps),
                    np.stack(acc)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    inp = _inputs()
    theta0 = np.asarray(torch_gp().get_parameter_vector())
    thetas = np.stack([theta0, theta0 + np.array([0.05, -0.1, 0.2])])
    inp["thetas"] = thetas
    stages = _jax_smc_stages(jax.random.PRNGKey(4), 64, 2, 2, SMC_STAGES)
    z0_mesh = theta0 + 0.05 * np.random.default_rng(3).standard_normal(
        (8, len(theta0)))
    out = spawn(tmp_path_factory.mktemp("parallel"), {
        4: [("pooling", inp["pooling"]), ("data", (thetas,)),
            ("mesh_hmc", (z0_mesh,))],
        2: [("samplers", inp["samplers"]), ("data", (thetas,)),
            ("smc", (inp["p0"], stages))],
    })
    out["inputs"] = inp
    return out


def test_pooling_is_exact(runs):
    """Rank-local Welford + one merge == one global pass; the batch update
    over the axis == the same global update; DA synced every step == one
    stream fed the pooled accept means (the JAX package's da_update)."""
    import jax.numpy as jnp
    from george_tpu.samplers import adaptation as jadapt

    zs, accepts = runs["inputs"]["pooling"]
    flat = zs.reshape(-1, 3)
    gmean = flat.mean(0)
    gm2 = (flat - gmean).T @ (flat - gmean)
    both = np.concatenate([flat, flat + 1.0])
    bmean = both.mean(0)
    bm2 = (both - bmean).T @ (both - bmean)
    da = jadapt.da_init(jnp.asarray(0.5))
    pooled = []
    for a in accepts.mean(axis=1):
        da = jadapt.da_update(da, a, target=0.8)
        pooled.append(float(da.log_step))
    for rank in runs[4]:
        for dense in (True, False):
            merged, batch = rank["pooling"][dense]
            for st, mean, m2, count in ((merged, gmean, gm2, 64),
                                        (batch, bmean, bm2, 128)):
                assert float(st.count) == count
                np.testing.assert_allclose(st.mean.numpy(), mean,
                                           atol=1e-12)
                np.testing.assert_allclose(
                    st.m2.numpy(), m2 if dense else np.diag(m2), atol=1e-10)
        np.testing.assert_allclose(rank["pooling"]["da"].numpy(), pooled,
                                   rtol=1e-12)


def test_chain_sharded_samplers_match_run_mcmc(runs):
    """ChEES and HMC with chains over two ranks: the pooled step size and
    mass matrix the same bits on both, every chain its own stream, the
    draws gathered the same on both, and the moments those of
    ``run_mcmc`` on one process (within 0.12 of the scale).  HMC over a
    2 x 2 (chains x data) mesh: finite draws, mean acceptance > 0.2, the
    same draws on every rank."""
    from george_tpu_torch.samplers import run_mcmc, split_rhat

    mesh_runs = [r["mesh_hmc"] for r in runs[4]]
    for res in mesh_runs:
        assert res.samples.shape == (8, 20, 3)
        assert bool(torch.all(torch.isfinite(res.samples)))
        assert float(res.accept_prob.mean()) > 0.2
        assert torch.equal(res.samples, mesh_runs[0].samples)

    z0, = runs["inputs"]["samplers"]
    r0, r1 = (r["samplers"] for r in runs[2])
    for algorithm, kw in SAMPLER_RUNS:
        a, b = r0[algorithm], r1[algorithm]
        assert a.step_size.numpy().tobytes() == b.step_size.numpy().tobytes()
        assert a.inv_mass.numpy().tobytes() == b.inv_mass.numpy().tobytes()
        assert torch.equal(a.samples, b.samples)
        assert a.samples.shape == (64, kw["num_samples"], 2)
        chain_means = a.samples[:, :, 0].mean(1).numpy()
        assert len(np.unique(np.round(chain_means, 8))) == 64
        if algorithm == "chees":
            # (Fixed-length HMC on a Gaussian mixes by its path length:
            # only its moments are held, as the JAX package's test does.)
            assert float(split_rhat(a.samples).max()) < 1.05
        single = run_mcmc(gaussian_log_prob, torch.as_tensor(z0), 3,
                          algorithm=algorithm, device="cpu", **kw)
        m_sh = a.samples.reshape(-1, 2).mean(0).numpy()
        m_un = single.samples.reshape(-1, 2).mean(0).numpy()
        assert np.all(np.abs(m_sh - m_un) < 0.12 * SCALE), algorithm
        assert np.all(np.abs(m_sh - MU) < 0.12 * SCALE), algorithm


def test_data_sharded_log_prob_matches_jax(runs):
    """Both routes, and the distributed route padded, at P = 2 and 4: the
    value and the gradient on every rank equal the JAX package's jitted
    ``build_gp_log_prob`` (dense) at rtol 1e-10."""
    import jax
    import jax.numpy as jnp
    import george_tpu
    from george_tpu import kernels as jk
    from george_tpu.samplers import build_gp_log_prob as jax_build

    thetas = runs["inputs"]["thetas"]
    engines = {"replicated": "sharded_replicated_chol", "dist": "dist_chol",
               "dist_padded": "dist_chol"}
    for route, n in DATA_CASES:
        x, y, yerr = gp_data(n)
        jgp = george_tpu.GP(1.5 * jk.Matern32Kernel(0.9),
                            white_noise=np.log(1e-3), fit_white_noise=True)
        jlp, _ = jax_build(jgp, x, y, yerr, method="dense")
        vg = jax.jit(jax.value_and_grad(jlp))
        refs = [vg(jnp.asarray(th)) for th in thetas]
        ref_v = np.array([float(v) for v, _ in refs])
        ref_g = np.stack([np.asarray(g) for _, g in refs])
        for P in (2, 4):
            for rank in runs[P]:
                engine, n_total, val, grad, single = rank["data"][route]
                assert engine == engines[route]
                assert n_total == (128 if route == "dist_padded" else n)
                np.testing.assert_allclose(val.numpy(), ref_v, rtol=RTOL,
                                           err_msg=route)
                np.testing.assert_allclose(float(single), ref_v[0],
                                           rtol=RTOL, err_msg=route)
                np.testing.assert_allclose(
                    grad.numpy(), ref_g, rtol=RTOL,
                    atol=RTOL * np.abs(ref_g).max(),
                    err_msg="{0} P={1}".format(route, P))


def test_sharded_smc_matches_single_process_and_jax(runs):
    """Particle-sharded SMC: the port's ``run_smc`` on one process from the
    same seed, and the JAX package's ``run_smc`` on its key stream, at
    rtol 1e-10 (stages, particles, log evidence)."""
    import jax
    import jax.numpy as jnp
    from george_tpu.samplers.smc import run_smc as jax_run_smc
    from george_tpu_torch.samplers.smc import run_smc

    p0 = runs["inputs"]["p0"]
    single = run_smc(smc_target, smc_init, torch.as_tensor(p0), 3,
                     num_mutations=3, device="cpu")
    ref = jax_run_smc(
        lambda z: -0.5 * jnp.sum((z - 1.0) ** 2) / 0.3 ** 2,
        lambda z: -0.5 * jnp.sum(z ** 2) / 2.0 ** 2, jnp.asarray(p0),
        jax.random.PRNGKey(4), num_mutations=2, num_leapfrog=3,
        mutation="hmc", max_stages=SMC_STAGES)
    for rank in runs[2]:
        rw, hmc = rank["smc"]["rw"], rank["smc"]["hmc_jax_stream"]
        assert rw.num_stages == single.num_stages
        np.testing.assert_allclose(rw.particles.numpy(),
                                   single.particles.numpy(), rtol=RTOL)
        np.testing.assert_allclose(float(rw.log_evidence),
                                   float(single.log_evidence), rtol=RTOL)
        # Each rank evaluated its half of the cloud.
        assert rw.num_evaluations == single.num_evaluations
        assert hmc.num_stages == int(ref.num_stages)
        np.testing.assert_allclose(hmc.particles.numpy(),
                                   np.asarray(ref.particles), rtol=RTOL,
                                   atol=RTOL)
        np.testing.assert_allclose(float(hmc.log_evidence),
                                   float(ref.log_evidence), rtol=RTOL)
        np.testing.assert_allclose(hmc.log_prob.numpy(),
                                   np.asarray(ref.log_prob), rtol=RTOL)
