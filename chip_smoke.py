#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

The main path is the hyperparameter posterior of ``1.0 * Matern32Kernel(1.0)``
with a fitted log white noise over N = 1000 sorted inputs, sampled by
ChEES-HMC with 16384 chains; every leapfrog is one launch of the hand-written
CUDA Kalman value+gradient kernel (``george_tpu_torch/csrc/kalman_vg.cu``).

Phases (any failure exits non-zero):

1. device and build: the card's name and power limit, every kernel
   instantiation built from the checkout's sources (in parallel), the
   ``-Xptxas -v`` register / shared-memory / spill lines;
2. kernel against its plain PyTorch version, at full width (B = 16384,
   N = 1000) and on a small zoo of kernels at B = 256, in float32 and float64;
3. exactness across methods: the state-space density at theta0 equals the
   dense ``GP.log_likelihood`` plus the prior, and the dense GP reproduces
   the published anchor 133.946394912;
4. the main path: ``run_mcmc(algorithm="chees")`` from two seeds, with the
   kernel's launch count, acceptance, divergences, split R-hat and the
   agreement of the posterior means checked;
5. timing of the kernel and of its plain version with CUDA events, beside
   the kernel's bound.

The second-to-last line of standard output is a JSON object describing each
kernel of the path; the last is ``{"ok": true, "device": {...}}``.  Without
a CUDA card, or without the package beside this script, it exits with
code 2 and prints no result.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores and HBM bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

N = 1000
CHAINS = 16384
ZOO_CHAINS = 256
WARMUP = 150
SAMPLES = 300
MAX_LEAPFROG = 64
BLOCK = 20
# The last warmup iterations after the final mass-matrix window, where the
# step size adapts alone (adaptation.build_schedule's term buffer).
TERM_BUFFER = 50
# The JAX package's ChEES run on this main path (same data, model, prior,
# initial spread and schedule; 512 chains in float64 on a CPU), seeds 1-3,
# from tools/chees_reference.py: (lowest, highest) over the seeds.  The
# draws run at dual averaging's averaged step size and so accept above the
# 0.651 target.
REF_DRAWS_ACCEPT = (0.8708, 0.9132)
REF_STEP_SIZE = (0.2572, 0.2967)
REF_LEAPFROGS_PER_DRAW = (7.72, 9.72)


def log(*args):
    print(*args, flush=True)


class Failure(Exception):
    pass


def check(ok, what):
    if not ok:
        raise Failure(what)
    log("  ok:", what)


def bench_data(n, seed=42):
    """The dataset of the JAX package's bench.py."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    yerr = 0.1 * np.ones(n)
    y = np.sin(x) + yerr * rng.standard_normal(n)
    return x, y, yerr


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi: " + out.stderr.strip()


# -- operation count of the kernel (for its bound) ----------------------------

# Primal operations of one filter step's transition for each family (Phi
# entries and Q = Pinf - Phi Pinf Phi^T over the structural non-zeros, as
# csrc/kalman_vg.cu's transition() computes them; exp / sin / cos count one).
_TRANSITION_OPS = {"matern0": 6, "matern1": 30, "matern2": 134,
                   "cosine": 22, "const": 3}


def step_ops(terms):
    """Primal operations of one predict + observe step of the kernel."""
    dims = [t.dim for t in terms]
    D, n_obs = sum(dims), len(dims)
    ops = 2 + sum(_TRANSITION_OPS[t.family] for t in terms)   # + residuals
    # predict: m = Phi m and P = Phi P Phi^T + Q within the blocks.
    for d in dims:
        ops += d * (2 * d - 1)                    # Phi m
        ops += d * D * (2 * d - 1)                # Phi P
    for i in range(D):
        for j in range(i + 1):
            dj = dims[_block_of(dims, j)]
            ops += 2 * dj - 1 + (1 if _block_of(dims, i) ==
                                 _block_of(dims, j) else 0)
    # observe (Joseph form): Ph, S, innovation, gain, mean, BP, P, acc.
    ops += D * (n_obs - 1) + 2 * n_obs + 1 + 3 * D
    ops += 2 * D * D + D * (n_obs - 1) + 5 * D * (D + 1) // 2 + 7
    return ops


def _block_of(dims, i):
    off = 0
    for b, d in enumerate(dims):
        if i < off + d:
            return b
        off += d
    raise IndexError(i)


def kalman_bound(spec, B, n, itemsize=4):
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth and
    a lower bound on the operations over the FP32 peak.  Operations: the
    primal step count times (1 + NA), since every tangent costs at least one
    operation per primal operation."""
    na = len(spec.active)
    nbytes = itemsize * (B * spec.d_full + 3 * n + B * (1 + na))
    ops = B * (n - 1) * (1 + na) * step_ops(spec.terms)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# -- helpers -------------------------------------------------------------------

def median_ms(fn, reps, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), float(np.min(times))


def compare(vg, theta, what, float32_like_plain=False):
    """float32 and float64 kernel against the float64 plain version.

    The float32 kernel is held to the reference's kernel tolerances, or,
    with ``float32_like_plain``, to the float32 plain version (the same
    formulas rounded in the same type): its largest error over the chains
    at most twice the plain version's, and its median error over the chains,
    for ll relative to |ll| and for the gradient, at most twice the plain
    version's median.  Where the filter's float32 rounding itself exceeds
    the reference's tolerances, that is the measure of a right kernel.
    """
    import torch
    from george_tpu_torch.ops import kalman

    t64 = theta.to(torch.float64)
    ll_ref, g_ref = kalman.kalman_vg_torch(vg.spec, t64, *vg.series(t64))
    if float32_like_plain:
        t32 = theta.to(torch.float32)
        ll_p, g_p = kalman.kalman_vg_torch(vg.spec, t32, *vg.series(t32))
        pe_ll = (ll_p.double() - ll_ref).abs()
        pe_g = (g_p.double() - g_ref).abs().amax(dim=1)
        p_ll, p_g = float(pe_ll.max()), float(pe_g.max())
        p_rel = float((pe_ll / ll_ref.abs()).median())
        p_gmed = float(pe_g.median())
        log("  {0} float32 plain version: max |ll err| {1:.3e}, max |grad "
            "err| {2:.3e}; median over chains |ll err|/|ll| {3:.3e}, "
            "|grad err| {4:.3e}".format(what, p_ll, p_g, p_rel, p_gmed))
    errs = {}
    for dtype in (torch.float32, torch.float64):
        ll, g = vg(theta.to(dtype).contiguous())
        torch.cuda.synchronize()
        ll, g = ll.double(), g.double()
        finite = bool(torch.all(torch.isfinite(ll)) and
                      torch.all(torch.isfinite(g)))
        e_ll = (ll - ll_ref).abs()
        e_g = (g - g_ref).abs()
        if dtype == torch.float32 and float32_like_plain:
            k_rel = float((e_ll / ll_ref.abs()).median())
            k_gmed = float(e_g.amax(dim=1).median())
            log("  {0} float32 kernel: median over chains |ll err|/|ll| "
                "{1:.3e}, |grad err| {2:.3e}".format(what, k_rel, k_gmed))
            ok = float(e_ll.max()) <= 2 * p_ll and \
                float(e_g.max()) <= 2 * p_g and \
                k_rel <= 2 * p_rel and k_gmed <= 2 * p_gmed
        elif dtype == torch.float32:
            # The reference's own kernel tolerances (float32 kernel against
            # a float64 filter, tests/test_pallas_kalman.py).
            ok = bool(torch.all(e_ll <= 1e-4 * ll_ref.abs() + 1e-2)) and \
                bool(torch.all(e_g <= 1e-3 * g_ref.abs() + 1e-2))
        else:
            # Same formulas in the same type: only rounding order differs.
            ok = bool(torch.all(e_ll <= 1e-9 * ll_ref.abs())) and \
                bool(torch.all(e_g <= 1e-9 * g_ref.abs() + 1e-9))
        err = max(float(e_ll.max()), float(e_g.max()))
        errs[dtype] = err
        check(finite and ok, "{0} {1}: max |ll err| {2:.3e}, max |grad err| "
              "{3:.3e} (|ll| up to {4:.4g})".format(
                  what, str(dtype).split(".")[-1], float(e_ll.max()),
                  float(e_g.max()), float(ll_ref.abs().max())))
    return errs


def full_thetas(gp, active, rng_seed, count, scale):
    """(count, D_full) full vectors around the GP's own, active entries
    jittered from a numpy seed."""
    base = gp.get_parameter_vector(include_frozen=True)
    rng = np.random.default_rng(rng_seed)
    out = np.tile(base, (count, 1))
    out[:, list(active)] += scale * rng.standard_normal((count, len(active)))
    return out


def main_gp(device):
    import george_tpu_torch as george
    from george_tpu_torch import kernels

    return george.GP(1.0 * kernels.Matern32Kernel(1.0),
                     white_noise=np.log(1e-4), fit_white_noise=True,
                     device=device)


def bench_prior(gp, device, dtype):
    import torch

    center = torch.as_tensor(gp.get_parameter_vector(), device=device,
                             dtype=dtype)
    return lambda th: -0.5 * torch.sum(((th - center) / 2.0) ** 2)


def zoo():
    from george_tpu_torch import kernels as k

    wn = dict(white_noise=np.log(1e-3), fit_white_noise=True)
    cases = {
        "exp": (lambda: 0.5 * k.ExpKernel(2.0), wn),
        "matern32": (lambda: 1.7 * k.Matern32Kernel(0.8), wn),
        "matern52": (lambda: 2.0 * k.Matern52Kernel(1.3), wn),
        "cosine_plus": (lambda: 0.3 * k.CosineKernel(log_period=0.7)
                        + 1.1 * k.Matern32Kernel(2.0), wn),
        "const_plus": (lambda: k.ConstantKernel(log_constant=-0.5)
                       + k.ExpKernel(1.0), wn),
        "sum3": (lambda: 1.7 * k.Matern32Kernel(0.8) + 0.5 * k.ExpKernel(2.0)
                 + 2.0 * k.Matern52Kernel(1.3), wn),
        "frozen": (lambda: 2.0 * k.ExpKernel(1.5), {}),
        "mean_active": (lambda: 1.2 * k.Matern32Kernel(0.5),
                        dict(wn, mean=0.1, fit_mean=True)),
    }
    return cases


# -- the phases ----------------------------------------------------------------

def run(dev, card):
    import torch
    import george_tpu_torch as george
    from george_tpu_torch import _build, kernels
    from george_tpu_torch.ops import kalman
    from george_tpu_torch.samplers import (build_gp_log_prob, run_mcmc,
                                           effective_sample_size, split_rhat)

    t_run = time.time()

    def phase(title):
        log("phase {0} (at {1:.1f} s)".format(title, time.time() - t_run))

    # -- phase 1: device and build -----------------------------------------
    phase("1: device and build")
    x, y, yerr = bench_data(N)
    gp = main_gp(dev)
    log_prob, theta0 = build_gp_log_prob(
        gp, x, y, yerr, log_prior=bench_prior(gp, dev, torch.float32),
        device=dev, dtype=torch.float32)
    check(log_prob.engine == "cuda_kalman",
          "main path engine is {0}".format(log_prob.engine))
    main_vg = log_prob.kalman_vg
    spec = main_vg.spec
    check(spec.d_full == 4 and spec.active == (1, 2, 3),
          "main path layout: D_full={0}, active={1}".format(spec.d_full,
                                                            spec.active))

    xz, yz, yerrz = bench_data(200)
    zoo_vgs = {}
    for name, (make, kw) in zoo().items():
        g = george.GP(make(), device=dev, **kw)
        if name == "frozen":
            g.freeze_parameter("kernel:k1:log_constant")
        lp, _ = build_gp_log_prob(g, xz, yz, yerrz, device=dev)
        zoo_vgs[name] = (g, lp.kalman_vg)
    labelled = [("main path", main_vg)] + [(name, v) for name, (_, v)
                                           in zoo_vgs.items()]
    defines = [vg.spec.defines(dt) for _, vg in labelled
               for dt in (torch.float32, torch.float64)]
    t0 = time.time()
    libs = _build.build(kalman.SOURCE, defines)
    build_s = time.time() - t0
    log("  built {0} instantiations ({1} distinct) of {2} in {3:.2f} s "
        "(parallel nvcc)".format(len(defines), len(set(libs)), kalman.SOURCE,
                                 build_s))
    for label, vg in labelled:
        for dt in (torch.float32, torch.float64):
            lines = [line for line in _build.ptxas_report(
                kalman.SOURCE, vg.spec.defines(dt))
                if "registers" in line or "spill" in line]
            log("  ptxas {0} {1} NA={2}: {3}".format(
                label, str(dt).split(".")[-1], len(vg.spec.active),
                " | ".join(lines)))

    # -- phase 2: kernel against the plain version --------------------------
    phase("2: kernel against the plain version")
    theta_main = torch.as_tensor(
        full_thetas(gp, spec.active, 7, CHAINS, 0.1), device=dev)
    errs = compare(main_vg, theta_main,
                   "main path B={0} N={1}".format(CHAINS, N))
    for name, (g, vg) in zoo_vgs.items():
        th = torch.as_tensor(full_thetas(g, vg.spec.active, 11, ZOO_CHAINS,
                                         0.2), device=dev)
        compare(vg, th, "zoo {0} B={1} N=200 active={2}".format(
            name, ZOO_CHAINS, vg.spec.active))

    # -- phase 3: exactness across methods ------------------------------------
    phase("3: exactness across methods (float64)")
    prior64 = bench_prior(gp, dev, torch.float64)
    lp64, theta64 = build_gp_log_prob(gp, x, y, yerr, log_prior=prior64,
                                      device=dev, dtype=torch.float64)
    gp.compute(x, yerr)
    dense = float(gp.log_likelihood(y) + gp.log_prior()
                  + float(prior64(theta64)))
    ss = float(lp64(theta64))
    check(abs(ss - dense) <= 1e-10 * abs(dense),
          "state-space log_prob {0!r} == dense {1!r} (rtol 1e-10)".format(
              ss, dense))
    lp_k, g_k = lp64.batched_value_and_grad(theta64[None])
    g_dense = gp.grad_log_likelihood(y)
    check(abs(float(lp_k[0]) - dense) <= 1e-10 * abs(dense) and
          np.allclose(g_k[0].cpu().numpy(), g_dense, rtol=1e-8, atol=1e-8),
          "float64 kernel value {0!r} and gradient {1} match the dense GP "
          "(rtol 1e-10 / 1e-8)".format(float(lp_k[0]), g_dense))
    # The JAX package's tests/test_gp.py anchor dataset.
    xa = np.sort(np.random.RandomState(1234).uniform(0, 10, 50000))
    ya = np.sin(xa)
    ga = george.GP(np.var(ya) * kernels.ExpSquaredKernel(1.0), device=dev)
    ga.compute(xa[:100], 0.1 * np.ones(100))
    anchor = float(ga.log_likelihood(ya[:100]))
    check(abs(anchor - 133.946394912) < 1e-6,
          "dense anchor {0!r} (published 133.946394912)".format(anchor))

    # -- phase 4: the main path -------------------------------------------------
    phase("4: the main path, ChEES over {0} chains".format(CHAINS))
    z0 = theta0 + 0.1 * torch.as_tensor(
        np.random.default_rng(0).standard_normal((CHAINS, len(theta0))),
        device=dev, dtype=theta0.dtype)

    def progress(phase, done, total):
        if done == total:
            log("  {0} {1}/{2}".format(phase, done, total))

    runs = []
    for seed in (1, 2):
        kalman.kalman_vg.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        res = run_mcmc(log_prob, z0, seed, algorithm="chees",
                       num_warmup=WARMUP, num_samples=SAMPLES,
                       num_leapfrog=MAX_LEAPFROG, block_size=BLOCK,
                       warmup_block_size=BLOCK, progress=progress,
                       device=dev)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = kalman.kalman_vg.launches
        runs.append((res, seconds, launches))
        draw_leaps = int(res.n_leapfrog[0].sum())
        check(launches == res.num_evaluations and
              launches >= draw_leaps + WARMUP,
              "seed {0}: kernel launches {1} == value+gradient calls {2} "
              "(>= {3} draw leapfrogs + {4} warmup iterations)".format(
                  seed, launches, res.num_evaluations, draw_leaps, WARMUP))
        check(bool(torch.all(torch.isfinite(res.samples))),
              "seed {0}: all {1} draws finite".format(
                  seed, tuple(res.samples.shape)))
        # Dual averaging holds the warmup's acceptance at the 0.651 target;
        # the draws run at the averaged (smaller) step size and so accept
        # more.  The draws, the step size and the trajectory length are held
        # to the JAX package's run (REF_*): within 0.03 of its range of
        # acceptance over seeds, 10% of its range of step sizes and 20% of
        # its range of leapfrogs per draw, margins for 16384 chains against
        # 512 and float32 against float64.
        warm_acc = float(res.warmup_accept_prob[-TERM_BUFFER:].double()
                         .mean())
        check(abs(warm_acc - 0.651) <= 0.15,
              "seed {0}: mean acceptance of the last {1} warmup iterations "
              "{2:.4f} within 0.15 of 0.651".format(seed, TERM_BUFFER,
                                                    warm_acc))
        acc = float(res.accept_prob.double().mean())
        lo, hi = REF_DRAWS_ACCEPT[0] - 0.03, REF_DRAWS_ACCEPT[1] + 0.03
        check(lo <= acc <= hi,
              "seed {0}: mean acceptance of the draws {1:.4f} in [{2:.4f}, "
              "{3:.4f}] (JAX reference {4})".format(seed, acc, lo, hi,
                                                   REF_DRAWS_ACCEPT))
        eps = float(res.step_size)
        lo, hi = 0.9 * REF_STEP_SIZE[0], 1.1 * REF_STEP_SIZE[1]
        check(lo <= eps <= hi,
              "seed {0}: step size {1:.4f} in [{2:.4f}, {3:.4f}] (JAX "
              "reference {4})".format(seed, eps, lo, hi, REF_STEP_SIZE))
        leaps = float(res.n_leapfrog.double().mean())
        lo = 0.8 * REF_LEAPFROGS_PER_DRAW[0]
        hi = 1.2 * REF_LEAPFROGS_PER_DRAW[1]
        check(lo <= leaps <= hi,
              "seed {0}: {1:.2f} leapfrogs per draw in [{2:.2f}, {3:.2f}] "
              "(JAX reference {4})".format(seed, leaps, lo, hi,
                                           REF_LEAPFROGS_PER_DRAW))
        div = float(res.diverging.double().mean())
        check(div < 0.01, "seed {0}: divergence fraction {1:.5f} < 0.01"
              .format(seed, div))
        rhat = float(split_rhat(res.samples.double()).max())
        check(rhat < 1.01, "seed {0}: max split R-hat {1:.5f} < 1.01".format(
            seed, rhat))
        ess = effective_sample_size(res.samples.double())
        log("  seed {0}: ESS/s {1:.1f} (min ESS {2:.1f} over {3:.2f} s), "
            "{4:.2f} leapfrogs per draw, step size {5:.4f}; on {6}".format(
                seed, float(ess.min()) / seconds, float(ess.min()), seconds,
                leaps, eps, card))

    means, ses = [], []
    for res, _, _ in runs:
        s = res.samples.double().reshape(-1, res.samples.shape[-1])
        ess = effective_sample_size(res.samples.double())
        means.append(s.mean(0))
        ses.append(s.std(0) / torch.sqrt(ess))
    gap = (means[0] - means[1]).abs()
    bound = 5.0 * torch.sqrt(ses[0] ** 2 + ses[1] ** 2)
    check(bool(torch.all(gap <= bound)),
          "posterior means {0} and {1} agree within 5 MC standard errors "
          "(gap {2}, bound {3})".format(
              means[0].cpu().numpy(), means[1].cpu().numpy(),
              gap.cpu().numpy(), bound.cpu().numpy()))

    final = runs[0][0].samples[:, -1].double()
    th_final = torch.as_tensor(np.tile(gp.get_parameter_vector(
        include_frozen=True), (CHAINS, 1)), device=dev)
    th_final[:, list(spec.active)] = final
    # At the posterior (length scales ~4.5 against gaps ~0.01) the process
    # noise Q = Pinf - Phi Pinf Phi^T cancels to a few float32 digits, in
    # the plain version as in the kernel (and the JAX package's): the float32
    # kernel is held to the float32 plain version there, the float64 kernel
    # to rtol 1e-9.
    compare(main_vg, th_final, "final chain positions B={0}".format(CHAINS),
            float32_like_plain=True)

    # -- phase 5: timing ------------------------------------------------------------
    phase("5: timing at B={0}, N={1} (CUDA events)".format(CHAINS, N))
    th32 = theta_main.float().contiguous()
    ms, ms_min = median_ms(lambda: main_vg(th32), reps=50)
    plain_ms, plain_min = median_ms(
        lambda: kalman.kalman_vg_torch(spec, th32, *main_vg.series(th32)),
        reps=20, warmup=1)
    bound_ms, bound_by = kalman_bound(spec, CHAINS, N)
    log("  kernel float32: median {0:.4f} ms (min {1:.4f}) over 50 launches"
        .format(ms, ms_min))
    log("  plain version float32: median {0:.2f} ms (min {1:.2f}) over 20 "
        "calls".format(plain_ms, plain_min))
    log("  bound {0:.4f} ms, set by {1} ({2} primal operations per step x "
        "(1 + {3} tangents), FP32 peak {4:.0f} TFLOP/s, HBM {5} TB/s); "
        "kernel at {6:.1%} of the bound; library call: none; on {7}".format(
            bound_ms, bound_by, step_ops(spec.terms), len(spec.active),
            PEAK_FP32 / 1e12, PEAK_BYTES / 1e12, bound_ms / ms, card))

    return [{
        "name": "kalman_vg",
        "route": "cuda",
        "source": "george_tpu_torch/csrc/kalman_vg.cu",
        "replaces": "george_tpu/ops/pallas_kalman.py:66",
        "launches": runs[0][2],
        "max_abs_err": errs[torch.float32],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import george_tpu_torch
    except ImportError as exc:
        print("chip_smoke: the george_tpu_torch package is not beside this "
              "script ({0})".format(exc), file=sys.stderr)
        return 2
    pkg_dir = os.path.dirname(os.path.abspath(george_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        print("chip_smoke: george_tpu_torch was imported from {0}, not from "
              "this checkout".format(pkg_dir), file=sys.stderr)
        return 2

    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(card)
    log("torch {0}, CUDA {1}, device {2}, {3} visible".format(
        torch.__version__, torch.version.cuda, name,
        torch.cuda.device_count()))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    try:
        kernels = run(dev, card)
    except Failure as exc:
        print("chip_smoke: FAILED: {0}".format(exc), file=sys.stderr)
        return 1
    log("all phases passed in {0:.1f} s".format(time.time() - t0))
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
