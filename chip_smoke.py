#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 28-30   # the multi-rank layer alone
    python3 chip_smoke.py --phases 31      # the examples alone

The paths, each through the entry points a user calls, each over
hand-written CUDA kernels but HODLR's:

* the main path: the hyperparameter posterior of ``1.0 *
  Matern32Kernel(1.0)`` with a fitted log white noise over N = 1000 sorted
  inputs, 16384 chains (``build_gp_log_prob``, ``run_mcmc(algorithm=
  "chees")``, then ``bench.py``'s NUTS leg, ``run_mcmc(algorithm="nuts",
  max_depth=4, persistent=True)``, and HMC), every leapfrog one launch of
  the Kalman value+gradient kernel (``george_tpu_torch/csrc/kalman_vg.cu``);
* the dense path (``benchmarks/config5.py``): ``1.0 * Matern32Kernel`` on
  two of three input axes under an axis-aligned metric, fitted mean and log
  white noise, N = 128, 4096 chains, every leapfrog one launch of the dense
  value+gradient kernel (``csrc/dense_vg.cu``, its kernel tree generated by
  ``dsl/cuda_codegen.py``);
* the long series (``benchmarks/kalman_stream.py``): the main path's model
  over N = 100,000 points, 1024 chains, through the Kalman kernel streaming
  the series (the role of the reference's streaming kernel);
* the GP API's large-N dense route (``benchmarks/chol16k.py``'s BASELINE
  model, ``1.0 * ExpSquaredKernel(1.0)`` with a fitted log white noise, at
  N = 16384 in float32): ``GP.compute`` / ``log_likelihood`` /
  ``grad_log_likelihood`` / ``predict`` and a short L-BFGS-B fit, every
  stationary covariance build a launch of the tiled build kernel and every
  gradient one of its VJP (``csrc/stationary_cov.cu``); config #5's kernel
  at N = 8192 and the vmapped dense sampler density at N = 1024 over the
  same kernels;
* the blocked dense engine (``config.dense_mxu_sampling = True``, the JAX
  package's MXU engine): config #5's posterior at N = 256 through
  ``build_gp_log_prob(method="dense")`` and ChEES over 1024 chains, every
  value+gradient a batched build, cuBLAS products and one launch of the
  spine kernel (``csrc/dense_spine.cu``) per 128-wide panel; and the
  batched A B^T benchmark (``tools/batched_mm.py``, the port of
  ``benchmarks/pallas_batched_mm.py``) over ``csrc/batched_mmT.cu``;
* the GP API's O(N) state-space solver (``examples/07_state_space.py``'s
  model and data, ``GP(kernel, solver=StateSpaceSolver)``, float64) at
  N = 20000 and 100,000, every ``grad_log_likelihood`` one launch of the
  Kalman kernel at B = 1, and ``optimize.minimize`` (batched restarts,
  every evaluation one launch at B = 1 + restarts);
* the HODLR solver and its sampler engine (``benchmarks/hodlr_sampler.py``'s
  model, ``BASELINE.json`` config 4: ``GP(kernel, solver=HODLRSolver)`` at
  N = 10^4 and a Matern32 GP at 10^5, ``build_gp_log_prob(method=
  "hodlr")`` under NUTS at N = 2048), plain PyTorch with no hand kernel;
* SMC at config 3 (``benchmarks/smc_period.py``: the ExpSine2 x
  ExpSquared GP, 4096 particles), every target evaluation one launch of the
  dense value+gradient kernel, and ADVI on the main path, every step one
  launch of the Kalman kernel;
* the multi-rank layer (``george_tpu_torch.parallel``): the main path and
  config #5 with their chains sharded over ranks (``run_mcmc_sharded``),
  the BASELINE model's likelihood and gradient data-sharded
  (``make_sharded_gp_log_prob_factory``, the distributed Cholesky), and SMC
  with its particles' evaluations sharded (``run_smc_sharded``).  The
  script needs one card: 2 or 4 ranks share it over a gloo process group
  (and one rank over NCCL), each rank on its own chains, data rows or
  particles, over the same kernels;
* the examples (``examples_torch/``, the JAX package's ``examples/`` in
  the port's idiom), each through its ``main``: the GP API (01, 03, 04,
  05), NUTS and ChEES on the state-space route over the Kalman kernel (02),
  SMC over the dense kernel (06), a mean model through the ``torch_value``
  hook on the plain dense route (08) and NUTS over the dense kernel (09).

Phases (any failure exits non-zero):

1. device and build: the card's name and power limit, every kernel
   instantiation built from the checkout's sources (one ``nvcc`` each, all
   in parallel; the Kalman zoo's in the background until phase 10), the
   ``-Xptxas -v`` register / shared-memory / spill lines and each
   library's ``nvcc`` seconds, the dynamic shared memory of the spine and
   batched-product kernels, and the segment count S the Kalman launcher
   picks at each shape it runs;
2. Kalman kernel against its plain PyTorch version at full width
   (B = 16384, N = 1000), at the launcher's S and at S forced to 1, 2, 4,
   7 and 64, and on short series (N = 1, 2, 5, 100: empty and ragged
   segments) at the same S;
3. exactness across methods: the state-space density at theta0 equals the
   dense ``GP.log_likelihood`` plus the prior, and the dense GP reproduces
   the published anchor 133.946394912;
4. the main path, ChEES from two seeds: launch count, acceptance,
   divergences, split R-hat, agreement of the posterior means;
5. timing of the Kalman kernel (at the launcher's S and an S sweep) and
   its plain version (CUDA events);
6. dense kernel against its plain version: config #5 at B = 4096, N = 128;
   N = 16 (one tile), 136, 192, 200, 208, 209 and 256 (float64's tiles in
   shared memory up to 208, in device memory from 209); a zoo at B = 256
   with a failed factorization and an out-of-bounds point;
7. the dense path, ChEES from two seeds, with the same gates as phase 4,
   and each run's wall time beside its launches times the kernel's time;
8. the long series: float32 kernel against float64 kernel at B = 1024,
   float64 kernel against the plain version just above N = 32768, and a
   short ChEES run through the entry points;
9. timing of the dense kernel (B = 4096: float32 and float64 at N = 128,
   float32 at N = 256) and of the Kalman kernel on the long series
   (B = 1024, N = 100,000; the launcher's S and an S sweep), beside their
   bounds and plain versions;
10. the Kalman kernel on a zoo of kernels at B = 256 against its plain
    version, at the launcher's S and at the forced S of phase 2;
11. the covariance kernels against their plain versions: each stationary
    spec at N1 = 1000, N2 = 777 and batched (B = 4), float64 at rtol 1e-9
    and float32 (K within 8 ulps of max |K|, gradients within the
    reference's float32 tolerances; a repeated backward call bit for bit
    the same); the compiler's route under
    ``config.pallas_covariance = "always"`` against ``"never"`` for metric
    types 0, 1 and 2, a sum of two leaves and a blocked leaf, with the
    launches each build predicts;
12. the GP API: the BASELINE model at N = 16384 (compute,
    log_likelihood, grad_log_likelihood, predict with return_var at 4096
    points and return_cov at 1024) on the float32 kernel route, the float32
    plain route and the float64 plain route: each call's launches as
    predicted, and the kernel route's errors against float64 at most twice
    the plain float32 route's (plus a stated floor); an 8-iteration
    L-BFGS-B fit over ``nll`` / ``grad_nll``; "auto" routing (N = 1024
    launches, N = 1000 and a blocked leaf do not); config #5's kernel at
    N = 8192 under the same gates;
13. the dense sampler density (``build_gp_log_prob(method="dense")``) at
    N = 1024 over 64 chains on a RationalQuadratic kernel: value and
    gradient, one batched forward and one batched backward launch, under
    the same accuracy gate;
14. timing of the covariance kernels and their plain versions at
    N = 16384 (d = 1), N = 8192 (d = 2; and d = 1 with a radial
    parameter) and over 64 chains at N = 1024 (phase 13's shape), with
    each backward's grid launches as the library counts them, their
    float32 errors at N = 16384, ``GP.compute`` at N = 16384 split into
    build, factor and the rest, beside ``cholesky_ex`` alone, and one
    ``grad_log_likelihood`` there on the kernel and plain routes;
15. the spine kernel against its plain version on config #5's first
    diagonal blocks at N = 256 over 4096 chains, four made non positive
    definite (float64 within 1e-9 of each chain's largest |T| and of
    |logdet|; float32 T within twice the float32 plain version's error,
    logdet within the reference's kernel tolerance; NaN exactly on the
    non-PD chains; a ragged call of 301 chains the same bits), and the
    batched product against its plain version at B = 4096, N = 128
    (float32 within 16 ulps of |a_i| |b_j| at 1, 8, 32 and 64 chains a
    block, float64 within 1e-12 of it);
16. the blocked engine through ``build_gp_log_prob`` (engine
    ``cuda_dense_mxu``) against float64 with the plain spine: config #5 at
    N = 200, 256 and 384 over 4096 chains and N = 512 over 1024 (float64
    at rtol 1e-9, float32 at the reference's kernel tolerances, one spine
    launch per panel), the general metric and a sum with a frozen
    parameter at N = 300, rejected points (-inf, zero gradient), one call
    with TF32 allowed globally (the same bits), and the float64 engine
    against the plain autograd density;
17. posterior fidelity (BENCH_NOTES.md's TPU finding, measured here):
    ChEES over config #5 at N = 256, 1024 chains, 150 + 600 iterations,
    on the blocked and on the fused engine from seeds of their own:
    divergences, split R-hat, the means within 5 combined MC standard
    errors, the stds within 10%, printed beside the TPU's table;
18. ``tools/batched_mm.py``'s measurement at B = 4096, N = 128;
19. timing: the spine in float32 and float64 (kernel, plain version,
    ``cholesky_ex`` + ``solve_triangular``, bound), the blocked engine's
    value+gradient at B = 4096, N = 256 split into build, factor, inverse,
    ll and the reverse pass beside the fused engine, and the batched
    product at each chain count beside ``torch.matmul``, its plain version
    and its bound;
20. the NUTS leg on the main path (max depth 4, trajectory-persistent,
    16384 chains, 150 warmup iterations, 300 draws in one block) from two
    seeds: launches == value+gradient calls, finite draws, divergences,
    split R-hat, the seeds' means, the means and stds against phase 4's
    ChEES run, the draws' acceptance, step size and leapfrogs per draw
    against the JAX package's run (``tools/nuts_reference.py``), and
    ``trajectory_health`` against it; the wall split into warmup and
    sampling, the loop iterations, the kernel's share of the wall, the host
    ms an iteration and the useful-leapfrog share;
21. per-draw NUTS (``persistent=False``, 50 draws) against phase 20: the
    means, the leapfrogs per draw, each mode's wall a draw;
22. HMC on the main path (4096 chains, 8 leapfrogs, 100 + 100) against
    phase 4's means and its warmup acceptance against the 0.8 target, and
    NUTS on the dense path (phase 7's, 4096 chains, 50 + 50) over the dense
    kernel;
23. the GP API's state-space solver in float64: at N = 2000 against the
    ``BasicSolver`` GP (log-likelihood at rtol 1e-9, gradient 1e-7,
    predictive mean and variance 1e-8); at N = 20000 and 100,000
    ``compute``, ``log_likelihood``, ``grad_log_likelihood``,
    ``apply_inverse``, ``predict`` at 1000 points with ``return_var`` and
    ``sample(size=2)``, each timed, the Kalman launches equal to the
    gradient calls, the kernel route's gradient against autograd through
    the associative-scan filter (rtol 1e-8) and both timed; a pickled
    ``BasicSolver`` GP answering without ``compute``; ``optimize.minimize``
    on the main path's model (63 restarts) and on the N = 20000 GP (15
    restarts), launches equal to evaluations, each optimum within 1e-6
    relative of ``scipy.optimize.minimize(method="L-BFGS-B")`` over
    ``nll`` / ``grad_nll`` from the best start;
24. the HODLR GP API in float64: config 4 at N = 10^4 at tol 1e-10
    against the dense ``BasicSolver`` (log-likelihood and gradient,
    ``np.allclose`` as the JAX package's tests/test_solvers.py asserts),
    and at the default tol 0.1 ``compute`` / ``log_likelihood`` /
    ``grad_log_likelihood`` / ``apply_inverse``, each timed (CUDA events)
    with its kernel launches and device time (``torch.profiler``); a
    Matern32 GP at N = 100,000 (9 levels, leaves of 196) at tol 1e-10
    against the exact ``StateSpaceSolver``, its calls timed the same way;
25. the HODLR sampler route at N = 2048 (config 4's match leg): the
    match leg's own density (tol 1e-4, pinned at the generating
    parameters) and the one sampled (tol 1e-8, pinned at the MAP) against
    the dense density around the MAP; NUTS (max depth 4) on both routes
    (64 chains on HODLR, the first 8 of their starts on the dense route),
    divergences, split R-hat and ``posteriors_agree``;
    one batched value+gradient at N = 2048 and at N = 10^4 (32 chains),
    timed, with its launches and the card's share of it;
26. SMC at config 3, HMC and random-walk mutations: ``dense_vg.cu``'s
    launches equal to the target's evaluations, the period posterior's
    median within 0.15 of the true period 2.3 (the benchmark's gate), and
    particle-mutations a second;
27. ADVI on the main path (mean-field, 1000 steps): one ``kalman_vg.cu``
    launch a step, the fitted mean within one posterior sd of phase 4's
    ChEES mean, the ELBO rising; a NUTS state checkpointed, restored on the
    card bit for bit, and the next transition from it the same bits.

28. chain-sharded sampling: the main path's ChEES leg (phase 4's model,
    16384 chains, 150 + 300, seed 1) over 2 ranks, and once over 1 rank
    on NCCL: each rank's Kalman launches equal to its value+gradient calls
    at B = 16384 / P, the pooled step size and mass the same bits on every
    rank, every chain distinct, split R-hat < 1.01, the means within 5
    combined MC standard errors of phase 4's; config #5 under NUTS (phase
    22's run) over 2 and 4 ranks, ``dense_vg.cu``'s launches equal to the
    evaluations on each rank, the means against phase 22's;
29. data-sharded likelihoods, float64, over 2 and 4 ranks: the BASELINE
    model (``benchmarks/chol16k.py``) at N = 16384 through the distributed
    Cholesky (``"auto"``), the replicated route at N = 4096 and a padded
    case at N = 16000: value within rtol 1e-9 and gradient within rtol
    1e-7 of the single-process ``GP.log_likelihood`` /
    ``grad_log_likelihood``, one covariance launch a value and one forward
    and one VJP launch a gradient on every rank, each call timed
    (``profiling.timeit``; one ``profiling.trace``) with each rank's peak
    memory (the padded case over 4 ranks only); HMC over chains x data on a
    2 x 2 mesh at N = 1024 (finite draws, mean acceptance > 0.2);
30. SMC at config 3 (phase 26's HMC run) over 2 ranks: stages,
    temperatures, particles and log evidence equal to phase 26's at rtol
    1e-10, ``dense_vg.cu`` launched on each rank at B = 2048.
    Each rank is a process of its own (``torch.multiprocessing``, one
    spawn of 4: the P = 2 jobs run on the first two) on the card, the
    NCCL rank this process; the kernels are built before the ranks start,
    which only load them.  Each phase prints the share of its wall spent
    in collectives.
31. the examples on the card (``EXAMPLE_SIZES``; 07 is phase 23's), each
    timed with its kernel launches: 01, 03, 04 and 05 (float64) against
    their runs with ``device="cpu"`` at rtol 1e-9 (the printed
    log-likelihoods, band width, NLLs, rms errors, gradients and kernel
    values), 01's L-BFGS one ``dense_vg.cu`` launch an evaluation, 04's
    analytic gradient within 1e-5 of its finite difference; 02 (64 chains,
    60 + 60) ``kalman_vg.cu`` launches equal to its NUTS and ChEES
    gradient calls, the two posteriors' means within 5 combined MC standard
    errors; 06 (2000 particles) ``dense_vg.cu`` launches equal to the
    evaluations, the period's median within 0.15 of 2.3; 08 (16 chains,
    80 + 80) its densities through the ``torch_value`` hook (dense and
    state-space routes) equal to the CPU's at rtol 1e-10, no hand kernel,
    the GP model's location (its split R-hat under 1.1) within 2 sd of the
    truth and the white-noise model's further from it; 09 (512
    chains, 150 + 150) ``dense_vg.cu`` launches equal to the calls, split
    R-hat under 1.1.

The second-to-last line of standard output is a JSON object describing each
kernel of the paths; the last is ``{"ok": true, "device": {...}}``.  Without
a CUDA card, or without the package beside this script, it exits with
code 2 and prints no result.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, FP64 and TF32 on the tensor cores (dense) and HBM bandwidth.
PEAK_FP32 = 67e12
PEAK_FP64 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12

N = 1000
CHAINS = 16384
ZOO_CHAINS = 256
# The Kalman kernel's split of a series over S segments: the counts forced
# beside the launcher's in phases 2 and 10 (N = 1000 and 200 are not
# multiples of 7), short series with ragged and empty segments (B =
# RAGGED_CHAINS), and the counts swept in the timing of phases 5 and 9.
FORCED_SEGMENTS = (1, 2, 4, 7, 64)
RAGGED_N = (1, 2, 5, 100)
RAGGED_CHAINS = 64
MAIN_SWEEP = (1, 2, 4, 8)
LONG_SWEEP = (1, 8, 16, 32, 64, 128)
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

# The dense path (benchmarks/config5.py).
DENSE_N = 128
DENSE_CHAINS = 4096
# 2000 draws, not the benchmark's 400: the axis-2 metric parameter mixes
# slowly (some 40 effective draws per chain in 400, in the plain float64
# engine as in the kernel), and 400 draws leave its split R-hat at ~1.025.
DENSE_SAMPLES = 2000
DENSE_MAX_LEAPFROG = 32
# The JAX package's ChEES run on the dense path (tools/chees_reference.py
# --path dense: the same data, model, prior, initial spread and warmup; 128
# chains, 100 draws, float64 on a CPU), seeds 1-3: (lowest, highest).
REF_DENSE_ACCEPT = (0.7931, 0.8333)
REF_DENSE_STEP_SIZE = (0.4331, 0.4553)
REF_DENSE_LEAPFROGS_PER_DRAW = (4.62, 6.01)
# Phase 6's other sizes (B = 512): one tile, padding, both sides of the
# float64 tiles' shared-memory limit (91 tiles at N = 208, 105 at 209), and
# the envelope's top.
DENSE_SIZES = (16, 136, 192, 200, 208, 209, 256)
DENSE_SMEM_LAST64 = 208
# Phase 9's timed shapes at B = DENSE_CHAINS: (dtype, N).
DENSE_TIMING = (("float32", 128), ("float64", 128), ("float32", 256))

# The long series (benchmarks/kalman_stream.py).
LONG_N = 100_000
LONG_CHAINS = 1024
# Just above the reference's SMEM-resident kernel, for the check against
# the plain version: a Python loop of N steps under autograd, ~2.3 ms a
# step on the card or the host alike, whatever the chain count.
LONG_CHECK_N = 32_769
LONG_CHECK_CHAINS = 2

# The GP API's dense route: the BASELINE model (benchmarks/chol16k.py's
# inputs, benchmarks/scaling.py's y = sin(x)), config #5's kernel, and the
# vmapped dense sampler density above the fused engine's envelope.
GP_N = 16384
GP_PREDICT_VAR = 4096
GP_PREDICT_COV = 1024
GP5_N = 8192
SAMPLER_N = 1024
SAMPLER_CHAINS = 64
# 8 fit iterations, not 20, for the script's time since phases 28-30
# (each objective ~0.7 s at N = 16384).
FIT_ITERATIONS = 8
EPS32 = float(np.finfo(np.float32).eps)
# The float32 covariance kernel against the float64 plain version on the
# same (float32) inputs: K within 8 float32 ulps of max |K| (the exp and
# the rounding of r2, a few ulps each).
K32_ULPS = 8
# The float32 kernel route of the GP against the float64 plain route: its
# error at most ROUTE_FACTOR times the float32 plain route's, plus
# ROUTE_FLOOR_ULPS float32 ulps of the quantity's largest magnitude.
ROUTE_FACTOR = 2.0
ROUTE_FLOOR_ULPS = 16

# The blocked dense engine (benchmarks/config5.py's model, config5_data's
# inputs): value and gradient against float64 at (N, chains) each, the
# general metric and a sum with a frozen parameter at MXU_TREE_N, and the
# posterior-fidelity ChEES pair at FID_N (BENCH_NOTES.md "MXU dense engine
# posterior fidelity": N = 256, ChEES, the same posterior).
MXU_SHAPES = ((200, 4096), (256, 4096), (384, 4096), (512, 1024))
MXU_TREE_N = 300
MXU_TREE_CHAINS = 1024
# float64 runs of the engine in slices of this many chains (the float64
# build's autograd residuals at N = 384 and 4096 chains exceed 40 GB).
MXU_SLICE = 1024
SPINE_CHAINS = 4096
# A ragged chain count for the spine (not a multiple of the chains an SM
# holds, nor of the card's 132 SMs).
SPINE_RAGGED = 301
FID_N = 256
FID_CHAINS = 1024
FID_SAMPLES = 600
FID_MAX_LEAPFROG = 32
# The JAX package's TPU run of that pair (BENCH_NOTES.md, ChEES, 512-1024
# chains x 300 draws): (mean, std) per parameter, printed beside the
# port's; they are the reference's TPU numbers, not the port's.
TPU_FIDELITY = {
    "dense_mxu (TPU)": ((-0.094, -7.987, -1.256, 2.027, 3.468),
                        (0.467, 1.495, 0.368, 0.371, 0.360)),
    "xla_dense (TPU)": ((-0.123, -8.054, -0.753, 2.443, 3.849),
                        (0.678, 1.480, 0.593, 0.511, 0.495)),
    "CPU x64 oracle": ((-0.116, -8.066, -0.757, 2.438, 3.843),
                       (0.654, 1.50, 0.600, 0.516, 0.499)),
}
# Phases 20-22: the main path's NUTS leg (bench.py's: max depth 4,
# trajectory-persistent, 16384 chains, blocks of 300 draws; 300 draws, not
# 3600: at 150 the split R-hat gate reads ~1.016), per-draw NUTS beside it
# (50 draws, for the script's time since phases 24-27), HMC, and NUTS on
# the dense path.
NUTS_DEPTH = 4
NUTS_SAMPLES = 300
PER_DRAW_SAMPLES = 50
HMC_CHAINS = 4096
HMC_WARMUP = 100
HMC_SAMPLES = 100
HMC_LEAPFROG = 8
DENSE_NUTS_WARMUP = 50
DENSE_NUTS_SAMPLES = 50
# The JAX package's NUTS run on this main path (same data, model, prior,
# initial spread and schedule, max depth 4, trajectory-persistent; 512
# chains in float64 on a CPU), seeds 1-3, from tools/nuts_reference.py:
# (lowest, highest) over the seeds of the draws' acceptance, the step size,
# the leapfrogs per draw and the share of draws of exactly 3 or 7
# leapfrogs.  Dual averaging targets 0.8 in warmup; the draws run at the
# averaged step size.
REF_NUTS_ACCEPT = (0.7954, 0.7978)
REF_NUTS_STEP_SIZE = (0.3206, 0.3264)
REF_NUTS_LEAPFROGS_PER_DRAW = (9.95, 10.15)
REF_NUTS_FRAC_3_OR_7 = (0.4181, 0.4419)
# The batched product (benchmarks/pallas_batched_mm.py's defaults).
MM_B, MM_N, MM_REP = 4096, 128, 20
# float32 products within MM_ULPS float32 ulps of |a_i| |b_j| (a dot
# product of length N rounds within ~sqrt(N) / 2 ulps of that, typically);
# float64 within 1e-12 of it.
MM_ULPS = 16
# Phase 23: examples/07_state_space.py's model and data through the GP
# API's state-space solver, at the example's N and a long series; the check
# against the dense solver at SS_CHECK_N; predictions at SS_PREDICT points;
# the fits' restarts.
SS_N = 20_000
SS_LONG_N = 100_000
SS_CHECK_N = 2000
SS_PREDICT = 1000
SS_TIMING_REPS = 20
FIT_RESTARTS_MAIN = 63
FIT_RESTARTS_SS = 15
# Phases 24-25: BASELINE.json config 4 (benchmarks/hodlr_sampler.py's
# model and data) through the HODLR solver and its sampler engine: the GP
# API at N = 10^4 (and a Matern32 GP at 10^5 against the exact O(N)
# solver); the benchmark's match leg (N = 2048, NUTS at max depth 4) on the
# HODLR and the dense route, and one batched value+gradient at N = 10^4
# over 32 chains.  The match leg's own density (MATCH_OPTS, pinned at the
# generating parameters) is off the dense one by up to ~10 nats at this
# posterior, whose mode lies ~3 units of log M away: it is printed, and
# the sampled density is pinned at the MAP with HODLR_OPTS instead (at tol
# 1e-6 a near-zero replayed pivot put 2.4% of the draws in divergences).
# The draws are cut, and the dense route's chains, to fit the script's
# time: a HODLR value+gradient at N = 2048 is host-bound at ~50 ms
# whatever the chain count up to the benchmark's 64, the dense one
# device-bound at ~3.4-5 ms a chain (~180 ms at 64).
HODLR_N = 10_000
HODLR_LONG_N = 100_000
HODLR_SAMPLER_N = 2048
HODLR_CHAINS = 64
HODLR_DENSE_CHAINS = 8
HODLR_BIG_CHAINS = 32
HODLR_WARMUP = 60
# 70 draws, not 100, for the script's time since phases 28-30.
HODLR_SAMPLES = 70
MATCH_OPTS = {"tol": 1e-4, "min_size": 256}
HODLR_OPTS = {"tol": 1e-8, "min_size": 256}
# Phase 26: BASELINE.json config 3 (benchmarks/smc_period.py): N = 120,
# 4096 particles, 8 mutations a stage; its gate: the period posterior's
# median within 0.15 of the true period.
SMC_N = 120
SMC_PARTICLES = 4096
SMC_MUTATIONS = 8
SMC_TRUE_PERIOD = 2.3
# Phase 27: ADVI on the main path (mean-field, 8 draws a step).
ADVI_STEPS = 1000
ADVI_MC = 8
# Phases 28-30: the multi-rank layer (parallel/).  P ranks share the one
# card the script needs, over a gloo group (the phase-28 ChEES leg also
# once at world size 1 over NCCL): the chain-sharded main path (phase 4's
# model and schedule) and config #5 under NUTS (phase 22's); the
# data-sharded BASELINE model of benchmarks/chol16k.py in float64 through
# the distributed Cholesky at N = 16384, the replicated route at 4096 and a
# padded case at 16000, and chains x data HMC on a 2 x 2 mesh
# (tests/test_parallel.py's test_chains_by_data_hmc at N = 1024); SMC at
# config 3 (phase 26's run, particle-sharded).
SHARD_WORLDS = (2, 4)
# (route, N, world sizes): the padded case at P = 4 only, for the script's
# time (the gloo transfers through the host make a value+gradient at
# N = 16384 7-15 s on an NVIDIA H100 80GB HBM3, 700.00 W).
SHARD_CASES = (("dist_chol", 16384, (2, 4)), ("replicated", 4096, (2, 4)),
               ("dist_chol padded", 16000, (4,)))
MESH_HMC_N = 1024
MESH_HMC_CHAINS = 2
SHARD_TIMEOUT_S = 600
# Phase 31: examples_torch/ (the JAX package's examples/ 01-09 in the
# port's idiom) through their main() on the card, 07 excepted (phase 23
# runs its model).  The sampler examples at reduced sizes, for the
# script's time: (chains, warmup = draws) against the examples' (64, 400)
# for 02, (128, 500) for 08 and (512, 200) for 09; 06 at its own 2000
# particles.  08's plain dense density is host-bound (~10 ms a call on the
# card): 80 warmup iterations are the fewest at which its GP model's
# location converged in CPU runs (50 left a split R-hat of 4.3 on the
# card), 16 chains keep its lockstep trees short.  The GP-API examples
# (01, 03, 04, 05) also run with device="cpu", their printed numbers held
# to the card's at EXAMPLE_RTOL.
EXAMPLE_SIZES = {"01": {}, "02": dict(chains=64, steps=60), "03": {},
                 "04": {}, "05": {}, "06": {},
                 "08": dict(chains=16, steps=80),
                 "09": dict(chains=512, steps=150)}
EXAMPLE_RTOL = 1e-9
# 08's custom-model hook: the card's float64 density against the CPU's at
# theta0 and EXAMPLE_HOOK_POINTS perturbed points.
EXAMPLE_HOOK_RTOL = 1e-10
EXAMPLE_HOOK_POINTS = 4


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


def config5_data(n=DENSE_N, seed=7):
    """The dataset of the JAX package's benchmarks/config5.py."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 8, (n, 3))
    yerr = 0.22 * np.ones(n)
    y = np.sin(x[:, 0]) + 0.3 * np.cos(x[:, 2]) \
        + yerr * rng.standard_normal(n)
    return x, y, yerr


def chol16k_data(n=GP_N):
    """benchmarks/chol16k.py's inputs and yerr, benchmarks/scaling.py's
    y = sin(x)."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 10, n))
    return x, np.sin(x), 0.1 * np.ones(n)


def stream_data(n=LONG_N, seed=0):
    """The dataset of the JAX package's benchmarks/kalman_stream.py."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, n / 33.0, n))
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


# -- operation counts of the kernels (for their bounds) -------------------------

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


def _bound(nbytes, ops, peak=PEAK_FP32):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kalman_bound(spec, B, n, itemsize=4):
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth and
    a lower bound on the operations over the FP32 peak.  Operations: the
    primal step count times (1 + NA), since every tangent costs at least one
    operation per primal operation."""
    na = len(spec.active)
    nbytes = itemsize * (B * spec.d_full + 3 * n + B * (1 + na))
    ops = B * (n - 1) * (1 + na) * step_ops(spec.terms)
    return _bound(nbytes, ops)


def dense_ops(spec, n):
    """Operations of one chain's value and gradient at the real n: the
    covariance build (the generated tree's primal operations per entry of
    the lower triangle), the Cholesky and the triangular inverse counted as
    a column-by-column pair does them, z = S r and alpha = S^T z,
    K^-1 = S^T S, and the gradient (the tree over Dual<T, NA>, at least
    (1 + NA) times its primal operations, plus the weight and NA
    multiply-adds per entry).  The tiled kernel (csrc/dense_vg.cu) does
    more: whole diagonal tiles, the products by T_jj, the padding to a
    multiple of 16."""
    from george_tpu_torch.dsl import cuda_codegen

    na = len(spec.active)
    tri = n * (n + 1) // 2
    tree = cuda_codegen.primal_ops(spec.node)
    build = tri * tree + n
    chol = sum(2 + (n - k - 1) + (n - k - 1) * (n - k) for k in range(n))
    trtri = sum(1 + (n - j - 1) * (n - j) + (n - j - 1) for j in range(n))
    solves = 4 * tri
    kinv = sum((j + 1) * 2 * (n - j) for j in range(n))
    grad = tri * ((1 + na) * tree + 3 + 2 * na)
    return build + chol + trtri + solves + kinv + grad + 2 * n


def dense_bound(spec, B, n, ndim, itemsize=4):
    """The bytes (theta, x, y and v read once, ll and the gradient written
    once) and the operations at the real n (the kernel's padding to a
    multiple of 16 is its own choice) at the FP32 or FP64 peak."""
    na = len(spec.active)
    nbytes = itemsize * (B * spec.d_full + n * (ndim + 2) + B * (1 + na))
    return _bound(nbytes, B * dense_ops(spec, n),
                  PEAK_FP32 if itemsize == 4 else PEAK_FP64)


def cov_fwd_bound(leaf, n1, n2, itemsize=4, B=1):
    """(bound_ms, bound_by) of the forward build: K written once, A1, A2
    and p read once; per entry r2 (3d operations) and the radial value."""
    from george_tpu_torch.dsl import cuda_codegen

    d = len(leaf.axes)
    vops, _ = cuda_codegen.radial_ops(leaf)
    nbytes = itemsize * B * (n1 * n2 + (n1 + n2) * d + leaf.nparams)
    return _bound(nbytes, B * n1 * n2 * (3 * d + vops))


def cov_bwd_bound(leaf, n1, n2, itemsize=4, B=1):
    """(bound_ms, bound_by) of the VJP: g, A1, A2 and p read once, dp, dA1
    and dA2 written once; per entry r2 (3d), the slope, W (1), W delta and
    its row and column sums (3d: dA1 = 2 sum_j W delta, dA2 = -2 sum_i W
    delta) and, where NP > 0, the value with its NP tangents (at least
    (1 + NP) times its primal operations) and NP products and sums."""
    from george_tpu_torch.dsl import cuda_codegen

    d, npar = len(leaf.axes), leaf.nparams
    vops, sops = cuda_codegen.radial_ops(leaf)
    nbytes = itemsize * B * (n1 * n2 + 2 * (n1 + n2) * d + 2 * npar)
    per = 3 * d + sops + 1 + 3 * d
    if npar:
        per += (1 + npar) * vops + 2 * npar
    return _bound(nbytes, B * n1 * n2 * per)


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


def kalman_call(vg, theta, segments=None):
    """The Kalman kernel over ``vg``'s series: at the launcher's segment
    count, or at ``segments``."""
    from george_tpu_torch.ops import kalman

    if segments is None:
        return vg(theta)
    return kalman.kalman_vg(vg.spec, theta, *vg.series(theta),
                            segments=segments)


def reverse_mode_grad(vg, theta):
    """The gradient of the plain Kalman log-likelihood at ``theta`` by
    autograd over the real filter (``kalman_vg_torch`` carries it in
    forward mode)."""
    import torch
    from george_tpu_torch.ops import kalman

    spec = vg.spec
    dt, y, v = vg.series(theta)
    n_scalar = spec.n_mean + spec.n_wn
    with torch.enable_grad():
        th = theta.detach().clone().requires_grad_(True)
        r = y - th[:, :1] if spec.n_mean else y
        var = v + torch.exp(th[:, spec.n_mean:spec.n_mean + 1]) \
            if spec.n_wn else v
        ll = kalman.kalman_loglike(spec.terms, th[:, n_scalar:], dt, r, var)
        g = torch.autograd.grad(ll.sum(), th)[0]
    return g[:, list(spec.active)].detach()


def compare(vg, theta, what, float32_like_plain=False, segments=(None,)):
    """float32 and float64 Kalman kernel against the float64 plain version,
    at each segment count of ``segments`` (None: the launcher's).

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
        # Beside the forward-mode gradient the gate reads, the same float32
        # filter's gradient by reverse mode (autograd over the real
        # arithmetic), printed only, so that the two yardsticks compare.
        a_g = (reverse_mode_grad(vg, t32).double() - g_ref).abs().amax(dim=1)
        log("  {0} float32 plain version, gradient by reverse mode: max "
            "|grad err| {1:.3e}, median over chains {2:.3e}".format(
                what, float(a_g.max()), float(a_g.median())))
    errs = {}
    for S, dtype in [(S, dt) for S in segments
                     for dt in (torch.float32, torch.float64)]:
        th = theta.to(dtype).contiguous()
        if S is not None and S > 1 and vg.spec.dim > kalman.MAX_SPLIT_DIM:
            try:
                kalman_call(vg, th, S)
                held = False
            except ValueError:
                held = True
            check(held, "{0} {1} S={2}: refused, a state of {3} dimensions "
                  "is held to S = 1".format(what, str(dtype).split(".")[-1],
                                            S, vg.spec.dim))
            continue
        ll, g = kalman_call(vg, th, S)
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
            ok = within_reference_tolerance(ll, g, ll_ref, g_ref)
        else:
            # Same formulas in the same type: only rounding order differs.
            ok = bool(torch.all(e_ll <= 1e-9 * ll_ref.abs())) and \
                bool(torch.all(e_g <= 1e-9 * g_ref.abs() + 1e-9))
        err = max(float(e_ll.max()), float(e_g.max()))
        errs[dtype] = max(errs.get(dtype, 0.0), err)
        check(finite and ok, "{0} {1} S={2}: max |ll err| {3:.3e}, max |grad "
              "err| {4:.3e} (|ll| up to {5:.4g})".format(
                  what, str(dtype).split(".")[-1],
                  launcher_segments(vg, th) if S is None else S,
                  float(e_ll.max()), float(e_g.max()),
                  float(ll_ref.abs().max())))
    return errs


def entry_name(line):
    """The function name of a ptxas "Compiling entry function '_ZN...'"
    line (the last name of the mangled nested name)."""
    mangled = line.split("'")[1] if "'" in line else line
    rest, name = mangled[3:] if mangled.startswith("_ZN") else mangled[2:], \
        mangled
    while rest[:1].isdigit():
        digits = len(rest) - len(rest.lstrip("0123456789"))
        size = int(rest[:digits])
        name, rest = rest[digits:digits + size], rest[digits + size:]
    return name


def launcher_segments(vg, theta):
    """The segment count the launcher picks for ``theta`` over ``vg``."""
    from george_tpu_torch.ops import kalman

    return kalman.choose_segments(theta.shape[0], len(vg.series(theta)[1]),
                                  vg.spec.dim)


def kalman_sweep(vg, th32, sweep, reps, card, what):
    """Median ms of the float32 kernel at the launcher's segment count and
    at each S of ``sweep`` (CUDA events), printed; returns the launcher's
    time and its minimum."""
    auto = launcher_segments(vg, th32)
    ms, ms_min = median_ms(lambda: vg(th32), reps=reps)
    log("  {0}: launcher's S={1}: median {2:.4f} ms (min {3:.4f}) over {4} "
        "launches; on {5}".format(what, auto, ms, ms_min, reps, card))
    for S in sweep:
        t, t_min = median_ms(lambda: kalman_call(vg, th32, S), reps=reps)
        log("    S={0} ({1}): median {2:.4f} ms (min {3:.4f})".format(
            S, launch_shape(S), t, t_min))
    return ms, ms_min


def launch_shape(S):
    """How a launch over S segments runs, in words."""
    from george_tpu_torch.ops import kalman

    if S == 1:
        return "one chain a thread"
    return "clusters of {0[0]} blocks of {0[1]} warps".format(
        kalman.cluster_shape(S))


def within_reference_tolerance(ll, g, ll_ref, g_ref):
    """The reference's own float32 kernel tolerances against a float64
    oracle (tests/test_pallas_kalman.py, tests/test_pallas_dense.py): ll
    within 1e-4 |ll| + 1e-2, gradient within 1e-3 |g| + 1e-2."""
    import torch

    return bool(torch.all((ll - ll_ref).abs() <= 1e-4 * ll_ref.abs() + 1e-2)) \
        and bool(torch.all((g - g_ref).abs() <= 1e-3 * g_ref.abs() + 1e-2))


def compare_dense(vg, theta, what):
    """float64 and float32 dense kernel against the float64 plain version:
    float64 at rtol 1e-9 (the same formulas in the same type), float32 at the
    reference's tolerances.  Chains whose factorization fails must be NaN in
    both; the rest are compared.  Returns the largest float32 error."""
    import torch
    from george_tpu_torch.ops import dense

    t64 = theta.to(torch.float64).contiguous()
    ll_ref, g_ref = dense.dense_vg_torch(vg.spec, t64, *vg.data(t64))
    failed = torch.isnan(ll_ref)
    ok_rows = ~failed
    err32 = 0.0
    for dtype in (torch.float64, torch.float32):
        ll, g = vg(theta.to(dtype).contiguous())
        torch.cuda.synchronize()
        ll, g = ll.double(), g.double()
        same_failures = bool(torch.equal(torch.isnan(ll), failed)) and \
            bool(torch.all(torch.isnan(g[failed])))
        lr, gr, lk, gk = ll_ref[ok_rows], g_ref[ok_rows], ll[ok_rows], \
            g[ok_rows]
        finite = bool(torch.all(torch.isfinite(lk)) and
                      torch.all(torch.isfinite(gk)))
        e_ll, e_g = (lk - lr).abs(), (gk - gr).abs()
        if dtype == torch.float64:
            ok = bool(torch.all(e_ll <= 1e-9 * lr.abs())) and \
                bool(torch.all(e_g <= 1e-9 * gr.abs() + 1e-9))
        else:
            ok = within_reference_tolerance(lk, gk, lr, gr)
            err32 = max(float(e_ll.max()), float(e_g.max()))
        check(finite and ok and same_failures,
              "{0} {1}: max |ll err| {2:.3e}, max |grad err| {3:.3e} (|ll| "
              "up to {4:.4g}; {5} failed factorizations in both)".format(
                  what, str(dtype).split(".")[-1], float(e_ll.max()),
                  float(e_g.max()), float(lr.abs().max()),
                  int(failed.sum())))
    return err32


def time_dense(dev, card, plain=True, reps=30):
    """The dense kernel at B = DENSE_CHAINS over config #5's model at each
    (dtype, N) of DENSE_TIMING (phase 6's inputs), beside its bound and,
    with ``plain``, its plain version's time, over CUDA events.  Returns
    [(dtype, N, ms, plain_ms, bound_ms, bound_by)].  tools/dense_vg_timing.py
    runs it against the package of another checkout."""
    import torch
    from george_tpu_torch.ops import dense
    from george_tpu_torch.samplers import build_gp_log_prob

    gp5 = config5_gp(dev)
    out = []
    for name, n in DENSE_TIMING:
        dtype = getattr(torch, name)
        lp, _ = build_gp_log_prob(gp5, *config5_data(n), method="dense",
                                  device=dev)
        vg = lp.dense_vg
        th = torch.as_tensor(full_thetas(gp5, vg.spec.active, 13,
                                         DENSE_CHAINS, 0.2),
                             device=dev).to(dtype).contiguous()
        ms, ms_min = median_ms(lambda: vg(th), reps=reps)
        plain_ms = median_ms(
            lambda: dense.dense_vg_torch(vg.spec, th, *vg.data(th)),
            reps=5, warmup=1)[0] if plain else None
        bound, by = dense_bound(vg.spec, DENSE_CHAINS, n, 3,
                                th.element_size())
        log("  dense kernel {0} B={1} N={2}: median {3:.4f} ms (min {4:.4f}) "
            "over {5} launches; plain version {6}; bound {7:.4f} ms set by "
            "{8} ({9:.4g} operations a chain); kernel at {10:.1%} of the "
            "bound; library call: none; on {11}".format(
                name, DENSE_CHAINS, n, ms, ms_min, reps,
                "not timed" if plain_ms is None else
                "{0:.2f} ms over 5 calls".format(plain_ms),
                bound, by, dense_ops(vg.spec, n), bound / ms, card))
        out.append((name, n, ms, plain_ms, bound, by))
        del th
    return out


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


def config5_gp(device, **kw):
    import george_tpu_torch as george
    from george_tpu_torch import kernels

    return george.GP(
        1.0 * kernels.Matern32Kernel(metric=[1.0, 2.0], ndim=3, axes=[0, 2]),
        white_noise=np.log(1e-3), fit_white_noise=True, mean=0.0,
        fit_mean=True, device=device, **kw)


def baseline_gp(device, dtype):
    """The BASELINE model: ``1.0 * ExpSquaredKernel(1.0)`` with a fitted log
    white noise."""
    import george_tpu_torch as george
    from george_tpu_torch import kernels

    return george.GP(1.0 * kernels.ExpSquaredKernel(1.0),
                     white_noise=np.log(1e-3), fit_white_noise=True,
                     device=device, dtype=dtype)


def cov_leaves():
    """One leaf of each stationary spec, as the kernels of phase 11 carry
    them: (label, leaf)."""
    from george_tpu_torch import kernels as k

    return [
        ("exp_squared d=1", k.ExpSquaredKernel(1.0).spec_node()),
        ("exp d=3", k.ExpKernel(1.0, ndim=3).spec_node()),
        ("matern32 d=2", k.Matern32Kernel(metric=[1.0, 2.0], ndim=3,
                                          axes=[0, 2]).spec_node()),
        ("matern52 d=1", k.Matern52Kernel(1.0).spec_node()),
        ("rational_quadratic d=1", k.RationalQuadraticKernel(
            log_alpha=0.3, metric=1.0).spec_node()),
    ]


def cov_trees():
    """(label, kernel, launches of one build) for the route checks of
    phase 11: metric types 0, 1 and 2, a sum of two stationary leaves, and
    a blocked leaf (which must not take the kernel)."""
    from george_tpu_torch import kernels as k

    return [
        ("isotropic", 1.3 * k.RationalQuadraticKernel(
            log_alpha=0.3, metric=0.8, ndim=2), 1),
        ("axis-aligned", 0.7 * k.Matern32Kernel(metric=[1.0, 2.0], ndim=3,
                                                axes=[0, 2]), 1),
        ("general", k.Matern52Kernel(metric=[[1.0, 0.3], [0.3, 2.0]],
                                     ndim=2), 1),
        ("sum", 0.5 * k.ExpSquaredKernel(metric=0.6, ndim=2)
         + k.ExpKernel(metric=[0.5, 1.5], ndim=2), 2),
        ("blocked", 0.3 * k.ExpSquaredKernel(2.0, ndim=2)
         + k.Matern32Kernel(metric=1.4, ndim=2, axes=[1],
                            block=[(-0.5, 0.5)]), 1),
    ]


def example07_kernel():
    """``examples/07_state_space.py``'s kernel."""
    from george_tpu_torch import kernels

    return 1.0 * kernels.Matern32Kernel(2.0) + 0.3 * kernels.ExpKernel(0.5)


def example07_data(n, seed=42):
    """``examples/07_state_space.py``'s data at ``n`` points."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 100, n))
    yerr = 0.1 * np.ones(n)
    y = np.sin(t) + 0.3 * np.cos(3.1 * t) + yerr * rng.standard_normal(n)
    return t, y, yerr


def example07_spec():
    """The Kalman kernel's spec on the state-space GP's gradient route: no
    mean parameter, the log white noise frozen, the kernel's four
    parameters active."""
    from george_tpu_torch.ops import kalman

    return kalman.make_kalman_vg(example07_kernel().spec_node(), [0.0, 1.0],
                                 [0.0, 0.0], [1.0, 1.0], 0, 1,
                                 (1, 2, 3, 4)).spec


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


def dense_zoo():
    """(kernel, GP keywords, parameter to freeze, N) of the dense zoo, on
    config #5's 3-D inputs.  Every kernel's first parameter is a log
    amplitude (the rejected points of phase 6 rely on it)."""
    from george_tpu_torch import kernels as k

    wn = dict(white_noise=np.log(1e-3), fit_white_noise=True)
    return {
        "expsq_iso": (lambda: 1.3 * k.ExpSquaredKernel(
            0.7, metric_bounds=[(-3.0, 3.0)], ndim=3), wn, None, 64),
        "matern52_frozen": (lambda: 2.0 * k.Matern52Kernel(metric=1.5,
                                                           ndim=3),
                            {}, "kernel:k1:log_constant", 21),
        "sum_product": (lambda: 0.5 * k.ExpSquaredKernel(
            metric=[0.6, 1.2], ndim=3, axes=[0, 1])
            + k.ConstantKernel(log_constant=-0.5, ndim=3)
            * k.Matern32Kernel(metric=2.0, ndim=3, axes=[2]), wn, None, 64),
        "rational_quadratic": (lambda: 0.9 * k.RationalQuadraticKernel(
            log_alpha=0.3, metric=[1.5, 0.7, 2.0], ndim=3),
            dict(wn, mean=0.2, fit_mean=True), None, 64),
        "non_stationary": (lambda: 0.8 * k.ExpKernel(metric=1.1, ndim=3)
                           + k.LinearKernel(log_gamma2=2.0, order=1.0,
                                            ndim=3, axes=[0]), wn, None, 64),
        "block_window": (lambda: 0.3 * k.ExpSquaredKernel(2.0, ndim=3)
                         + k.Matern32Kernel(metric=1.4, ndim=3, axes=[1],
                                            block=[(1.0, 6.0)]),
                         wn, None, 64),
    }


def chees_gates(res, seconds, launches, warmup, ref_accept, ref_step,
                ref_leaps, seed, card):
    """The sampler gates of phases 4 and 7.  Dual averaging holds the
    warmup's acceptance at the 0.651 target; the draws run at the averaged
    (smaller) step size and so accept more.  The draws, the step size and
    the trajectory length are held to the JAX package's run: within 0.03 of
    its range of acceptance over seeds, 10% of its range of step sizes and
    20% of its range of leapfrogs per draw (margins for thousands of chains
    against hundreds, and float32 against float64)."""
    import torch
    from george_tpu_torch.samplers import effective_sample_size, split_rhat

    draw_leaps = int(res.n_leapfrog[0].sum())
    check(launches == res.num_evaluations and
          launches >= draw_leaps + warmup,
          "seed {0}: kernel launches {1} == value+gradient calls {2} "
          "(>= {3} draw leapfrogs + {4} warmup iterations)".format(
              seed, launches, res.num_evaluations, draw_leaps, warmup))
    check(bool(torch.all(torch.isfinite(res.samples))),
          "seed {0}: all {1} draws finite".format(
              seed, tuple(res.samples.shape)))
    warm_acc = float(res.warmup_accept_prob[-TERM_BUFFER:].double().mean())
    check(abs(warm_acc - 0.651) <= 0.15,
          "seed {0}: mean acceptance of the last {1} warmup iterations "
          "{2:.4f} within 0.15 of 0.651".format(seed, TERM_BUFFER, warm_acc))
    acc = float(res.accept_prob.double().mean())
    lo, hi = ref_accept[0] - 0.03, ref_accept[1] + 0.03
    check(lo <= acc <= hi,
          "seed {0}: mean acceptance of the draws {1:.4f} in [{2:.4f}, "
          "{3:.4f}] (JAX reference {4})".format(seed, acc, lo, hi,
                                               ref_accept))
    eps = float(res.step_size)
    lo, hi = 0.9 * ref_step[0], 1.1 * ref_step[1]
    check(lo <= eps <= hi,
          "seed {0}: step size {1:.4f} in [{2:.4f}, {3:.4f}] (JAX "
          "reference {4})".format(seed, eps, lo, hi, ref_step))
    leaps = float(res.n_leapfrog.double().mean())
    lo, hi = 0.8 * ref_leaps[0], 1.2 * ref_leaps[1]
    check(lo <= leaps <= hi,
          "seed {0}: {1:.2f} leapfrogs per draw in [{2:.2f}, {3:.2f}] "
          "(JAX reference {4})".format(seed, leaps, lo, hi, ref_leaps))
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


def means_agree(runs):
    """The two seeds' posterior means within 5 Monte Carlo standard
    errors."""
    import torch
    from george_tpu_torch.samplers import effective_sample_size

    means, ses = [], []
    for res in runs:
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


def run_sampler(log_prob, z0, seeds, counter, dev, algorithm, **opts):
    """``run_mcmc`` from each seed, the kernel's launch count set to 0 just
    before each run and read just after, and read as well (with the wall
    clock) when warmup ends: [(result, seconds, launches, warmup seconds,
    warmup launches)]."""
    import torch
    from george_tpu_torch.samplers import run_mcmc

    out = []
    for seed in seeds:
        warm = []

        def progress(phase, done, total):
            if done == total:
                if phase == "warmup":
                    warm.append((time.time() - t0, counter.launches))
                log("  {0} {1}/{2}".format(phase, done, total))

        counter.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        res = run_mcmc(log_prob, z0, seed, algorithm=algorithm,
                       progress=progress, device=dev, **opts)
        torch.cuda.synchronize()
        out.append((res, time.time() - t0, counter.launches) + warm[0])
    return out


def run_chees(log_prob, z0, seeds, counter, dev, **opts):
    """ChEES from each seed: [(result, seconds, launches)]."""
    return [r[:3] for r in run_sampler(log_prob, z0, seeds, counter, dev,
                                       "chees", **opts)]


def posteriors_agree(a, b, what, stds=True):
    """Two runs' posterior means within 5 combined Monte Carlo standard
    errors and, with ``stds``, their stds within 10%."""
    import torch
    from george_tpu_torch.samplers import effective_sample_size

    stats = []
    for res in (a, b):
        s = res.samples.double()
        flat = s.reshape(-1, s.shape[-1])
        std = flat.std(0)
        stats.append((flat.mean(0), std,
                      std / torch.sqrt(effective_sample_size(s))))
    (m_a, s_a, se_a), (m_b, s_b, se_b) = stats
    gap = (m_a - m_b).abs()
    bound = 5.0 * torch.sqrt(se_a ** 2 + se_b ** 2)
    ratio = s_a / s_b
    ok = bool(torch.all(gap <= bound))
    if stds:
        ok = ok and bool(torch.all((ratio - 1).abs() <= 0.10))
    check(ok, "{0}: means {1} and {2}, gaps {3} within 5 combined MC "
          "standard errors {4}; std ratios {5}{6}".format(
              what, np.round(m_a.cpu().numpy(), 4),
              np.round(m_b.cpu().numpy(), 4), np.round(gap.cpu().numpy(), 5),
              np.round(bound.cpu().numpy(), 5),
              np.round(ratio.cpu().numpy(), 4),
              " within 10%" if stds else " (not gated)"))


def sampler_split(run, kernel_ms, chains, card, what):
    """Print a run's wall split into warmup and sampling, its loop
    iterations (batched value+gradient calls, one kernel launch each),
    launches x the kernel's time against the wall (the rest is the host's
    per iteration), the useful-leapfrog share of the sampling phase (the
    draws' leapfrogs over its iterations x chains) and min bulk ESS over
    the wall."""
    from george_tpu_torch.samplers import effective_sample_size

    res, seconds, launches, warm_s, warm_l = run
    draw_l = launches - warm_l
    kernel_s = launches * kernel_ms / 1e3
    useful = float(res.n_leapfrog.double().sum()) / (draw_l * chains)
    ess = float(effective_sample_size(res.samples.double()).min())
    log("  {0}: wall {1:.2f} s (warmup {2:.2f} s, {3} iterations; sampling "
        "{4:.2f} s, {5} iterations); launches x kernel time ({6:.4f} ms, "
        "phase 5) = {7:.2f} s ({8:.1%} of the wall), the host {9:.3f} ms an "
        "iteration beyond it; useful-leapfrog share of sampling {10:.4f} "
        "({11} leapfrogs over {5} x {12}); min bulk ESS {13:.1f}, {14:.1f} "
        "a second; on {15}".format(
            what, seconds, warm_s, warm_l, seconds - warm_s, draw_l,
            kernel_ms, kernel_s, kernel_s / seconds,
            (seconds - kernel_s) * 1e3 / launches, useful,
            int(res.n_leapfrog.sum()), chains, ess, ess / seconds, card))


def nuts_gates(run, seed, card):
    """Phase 20's per-run gates: launches, finite draws, divergences, split
    R-hat, and the draws' acceptance, step size and leapfrogs per draw held
    to the JAX package's run (tools/nuts_reference.py) within 0.03, 10% and
    20% of its range over seeds, as chees_gates widens its own; the
    trajectory lengths healthy (diagnostics.trajectory_health against the
    reference's mean, and the {3, 7} mass within 0.25 of its range)."""
    import torch
    from george_tpu_torch.samplers import split_rhat
    from george_tpu_torch.samplers.diagnostics import trajectory_health

    res, seconds, launches = run[:3]
    check(launches == res.num_evaluations,
          "seed {0}: kernel launches {1} == value+gradient calls {2}".format(
              seed, launches, res.num_evaluations))
    check(bool(torch.all(torch.isfinite(res.samples))),
          "seed {0}: all {1} draws finite".format(
              seed, tuple(res.samples.shape)))
    div = float(res.diverging.double().mean())
    check(div < 0.01, "seed {0}: divergence fraction {1:.5f} < 0.01".format(
        seed, div))
    rhat = float(split_rhat(res.samples.double()).max())
    check(rhat < 1.01, "seed {0}: max split R-hat {1:.5f} < 1.01".format(
        seed, rhat))
    acc = float(res.accept_prob.double().mean())
    lo, hi = REF_NUTS_ACCEPT[0] - 0.03, REF_NUTS_ACCEPT[1] + 0.03
    check(lo <= acc <= hi,
          "seed {0}: mean acceptance of the draws {1:.4f} in [{2:.4f}, "
          "{3:.4f}] (JAX reference {4})".format(seed, acc, lo, hi,
                                               REF_NUTS_ACCEPT))
    eps = float(res.step_size)
    lo, hi = 0.9 * REF_NUTS_STEP_SIZE[0], 1.1 * REF_NUTS_STEP_SIZE[1]
    check(lo <= eps <= hi,
          "seed {0}: step size {1:.4f} in [{2:.4f}, {3:.4f}] (JAX "
          "reference {4})".format(seed, eps, lo, hi, REF_NUTS_STEP_SIZE))
    leaps = float(res.n_leapfrog.double().mean())
    lo = 0.8 * REF_NUTS_LEAPFROGS_PER_DRAW[0]
    hi = 1.2 * REF_NUTS_LEAPFROGS_PER_DRAW[1]
    check(lo <= leaps <= hi,
          "seed {0}: {1:.2f} leapfrogs per draw in [{2:.2f}, {3:.2f}] (JAX "
          "reference {4})".format(seed, leaps, lo, hi,
                                  REF_NUTS_LEAPFROGS_PER_DRAW))
    expected = sum(REF_NUTS_LEAPFROGS_PER_DRAW) / 2.0
    health = trajectory_health(res.n_leapfrog, expected_mean=expected)
    sig = health["frac_truncation_signature"]
    lo, hi = REF_NUTS_FRAC_3_OR_7[0] - 0.25, REF_NUTS_FRAC_3_OR_7[1] + 0.25
    check(health["healthy"] and lo <= sig <= hi,
          "seed {0}: trajectories healthy: mean {1:.2f} leapfrogs within 25% "
          "of the reference's {2:.2f}, {3:.4f} of the draws at exactly 3 "
          "({4:.4f}) or 7 ({5:.4f}) leapfrogs in [{6:.4f}, {7:.4f}] (JAX "
          "reference {8}); at most {9} leapfrogs".format(
              seed, health["mean_leapfrog"], expected, sig,
              health["frac_3"], health["frac_7"], lo, hi,
              REF_NUTS_FRAC_3_OR_7, int(res.n_leapfrog.max())))


def cov_instances():
    """(label, dtype, instance) of every covariance kernel phases 11 to 15
    run, one per (radial function, d, dtype)."""
    import torch
    from george_tpu_torch.dsl.compiler import Op
    from george_tpu_torch.ops import cov

    def leaves(node):
        if isinstance(node, Op):
            return leaves(node.k1) + leaves(node.k2)
        return [node] if node.stationary and not node.blocked else []

    out, seen = [], set()
    named = cov_leaves() + [("route " + label, leaf)
                            for label, kern, _ in cov_trees()
                            for leaf in leaves(kern.spec_node())]
    for label, leaf in named:
        for dtype in (torch.float32, torch.float64):
            inst = cov.instance(leaf, dtype)
            if inst.key() not in seen:
                seen.add(inst.key())
                out.append(("stationary_cov " + label, dtype, inst))
    return out


def sharded_instances():
    """(label, dtype, instance) of the float64 covariance kernels phase 29
    launches (the BASELINE model's and the 2 x 2 mesh's Matern32)."""
    import torch
    from george_tpu_torch import kernels as k
    from george_tpu_torch.ops import cov

    return [("stationary_cov phase 29 " + label, torch.float64,
             cov.instance(leaf, torch.float64)) for label, leaf in (
                 ("exp_squared d=1", k.ExpSquaredKernel(1.0).spec_node()),
                 ("matern32 d=1", k.Matern32Kernel(1.0).spec_node()))]


def cov_counts():
    from george_tpu_torch.ops import cov

    return cov.stationary_cov_fwd.launches, cov.stationary_cov_bwd.launches


def reset_cov_counts():
    from george_tpu_torch.ops import cov

    cov.stationary_cov_fwd.launches = 0
    cov.stationary_cov_bwd.launches = 0


def check_close64(got, ref, what):
    """float64 kernel against the float64 plain version: the same formulas
    in the same type, rtol 1e-9 (and 1e-9 of the largest magnitude where an
    entry is near 0)."""
    import torch

    got, ref = got.double(), ref.double()
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    ok = bool(torch.all((got - ref).abs() <= 1e-9 * (ref.abs() + scale)))
    check(ok and bool(torch.all(torch.isfinite(got))),
          "{0}: max |err| {1:.3e} (max |ref| {2:.4g}; rtol 1e-9)".format(
              what, err, scale))
    return err


def check_k32(got, ref, what):
    """float32 K against float64 on the same inputs: K32_ULPS float32 ulps
    of max |K|."""
    import torch

    got, ref = got.double(), ref.double()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    check(err <= K32_ULPS * EPS32 * scale and
          bool(torch.all(torch.isfinite(got))),
          "{0}: max |err| {1:.3e} <= {2} float32 ulps of max |K| {3:.4g}"
          .format(what, err, K32_ULPS, scale))
    return err


def check_grad32(got, ref, what):
    """float32 gradients against float64: the reference's float32 kernel
    tolerance for gradients, 1e-3 |g| + 1e-2."""
    import torch

    got, ref = got.double(), ref.double()
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    check(bool(torch.all((got - ref).abs() <= 1e-3 * ref.abs() + 1e-2)) and
          bool(torch.all(torch.isfinite(got))),
          "{0}: max |err| {1:.3e} (max |ref| {2:.4g}; 1e-3 |g| + 1e-2)"
          .format(what, err, float(ref.abs().max()) if ref.numel() else 0.0))
    return err


def check_route(errs, what):
    """The float32 kernel route no less accurate than the float32 plain
    route: ``errs`` maps a quantity to (kernel error, plain error, largest
    magnitude), errors against the float64 plain route."""
    for name, (e_k, e_p, scale) in errs.items():
        limit = ROUTE_FACTOR * e_p + ROUTE_FLOOR_ULPS * EPS32 * scale
        check(np.isfinite(e_k) and e_k <= limit,
              "{0} {1}: kernel route |err| {2:.3e} <= {3} x plain route's "
              "{4:.3e} + {5} ulps of {6:.4g} ({7:.3e})".format(
                  what, name, e_k, ROUTE_FACTOR, e_p, ROUTE_FLOOR_ULPS,
                  scale, limit))


def check_cov_kernels(dev):
    """Phase 11: each leaf's kernels against the plain versions at
    N1 = 1000, N2 = 777 and batched at B = 4, N1 = 300, N2 = 257, in
    float64 (rtol 1e-9) and float32; then the compiler's route (metric types
    0, 1, 2, a sum, a blocked leaf) under "always" against "never".  A
    second float32 backward call must repeat the first bit for bit.
    Returns the largest float32 errors (forward, backward)."""
    import torch
    from george_tpu_torch import config
    from george_tpu_torch.dsl import compiler
    from george_tpu_torch.ops import cov

    rng = np.random.default_rng(31)
    err_f, err_b = 0.0, 0.0
    for label, leaf in cov_leaves():
        d = len(leaf.axes)
        for lead, n1, n2 in (((), 1000, 777), ((4,), 300, 257)):
            A1 = rng.uniform(-2, 2, lead + (n1, d))
            A2 = rng.uniform(-2, 2, lead + (n2, d))
            A2[..., :100, :] = A1[..., :100, :]     # r2 = 0 off the diagonal
            p = 0.3 + 0.1 * rng.standard_normal(lead + (leaf.nparams,))
            g = rng.standard_normal(lead + (n1, n2))
            for dtype in (torch.float64, torch.float32):
                args = [torch.as_tensor(v, device=dev, dtype=dtype)
                        for v in (p, A1, A2, g)]
                ref_args = [a.double() for a in args]
                K = cov.stationary_cov_fwd(leaf, *args[:3])
                grads = cov.stationary_cov_bwd(leaf, *args)
                torch.cuda.synchronize()
                K_ref = cov.stationary_cov_torch(leaf, *ref_args[:3])
                refs = cov.stationary_cov_vjp_torch(leaf, *ref_args)
                what = "{0} {1} {2}x{3}{4}".format(
                    label, str(dtype).split(".")[-1], n1, n2,
                    " B={0}".format(lead[0]) if lead else "")
                if dtype == torch.float64:
                    check_close64(K, K_ref, what + " K")
                    for name, a, b in zip(("dp", "dA1", "dA2"), grads, refs):
                        check_close64(a, b, what + " " + name)
                    continue
                err_f = max(err_f, check_k32(K, K_ref, what + " K"))
                for name, a, b in zip(("dp", "dA1", "dA2"), grads, refs):
                    err_b = max(err_b, check_grad32(a, b, what + " " + name))
                # No atomics: a second call gives the same bits.
                again = cov.stationary_cov_bwd(leaf, *args)
                check(all(bool(torch.equal(a, b))
                          for a, b in zip(grads, again)),
                      what + ": a second backward call is bit for bit the "
                      "same")
    x1 = rng.uniform(-2, 2, (1000, 3))
    x2 = rng.uniform(-2, 2, (777, 3))
    x2[:100] = x1[:100]
    g = rng.standard_normal((1000, 777))
    for label, kern, leaves in cov_trees():
        node = kern.spec_node()
        nd = kern.ndim
        theta = kern.get_parameter_vector(include_frozen=True)
        for dtype in (torch.float64, torch.float32):
            out = {}
            for route in ("always", "never"):
                config.pallas_covariance = route
                ins = [torch.as_tensor(v, device=dev, dtype=dtype)
                       .requires_grad_(True)
                       for v in (theta, x1[:, :nd], x2[:, :nd])]
                before = cov_counts()
                K = compiler.kernel_value_fn(node)(*ins)
                grads = torch.autograd.grad(
                    K, ins, torch.as_tensor(g, device=dev, dtype=dtype))
                torch.cuda.synchronize()
                after = cov_counts()
                out[route] = (K.detach(), grads,
                              (after[0] - before[0], after[1] - before[1]))
            config.pallas_covariance = "auto"
            what = "route {0} {1}".format(label, str(dtype).split(".")[-1])
            check(out["always"][2] == (leaves, leaves) and
                  out["never"][2] == (0, 0),
                  "{0}: launches (forward, backward) {1} under 'always' "
                  "(predicted {2}), {3} under 'never'".format(
                      what, out["always"][2], (leaves, leaves),
                      out["never"][2]))
            K, grads = out["always"][:2]
            K_ref, refs = out["never"][:2]
            if dtype == torch.float64:
                check_close64(K, K_ref, what + " K")
                for name, a, b in zip(("theta", "x1", "x2"), grads, refs):
                    check_close64(a, b, what + " d" + name)
            else:
                # The float64 plain route on the same float32 inputs.
                config.pallas_covariance = "never"
                ins = [torch.as_tensor(v, device=dev, dtype=torch.float32)
                       .double().requires_grad_(True)
                       for v in (theta, x1[:, :nd], x2[:, :nd])]
                K64 = compiler.kernel_value_fn(node)(*ins)
                refs = torch.autograd.grad(
                    K64, ins, torch.as_tensor(g, device=dev))
                config.pallas_covariance = "auto"
                check_k32(K, K64.detach(), what + " K")
                for name, a, b in zip(("theta", "x1", "x2"), grads, refs):
                    check_grad32(a, b, what + " d" + name)
    return err_f, err_b


def gp_calls(gp, x, y, yerr, t_var=None, t_cov=None):
    """compute / log_likelihood / grad_log_likelihood (and predict with
    return_var at ``t_var``, with return_cov at ``t_cov``), each call's
    (forward, backward) launches beside its result."""
    import torch

    out, launches = {}, {}

    def call(name, fn):
        before = cov_counts()
        out[name] = fn()
        torch.cuda.synchronize()
        after = cov_counts()
        launches[name] = (after[0] - before[0], after[1] - before[1])

    call("compute", lambda: gp.compute(x, yerr))
    call("log_likelihood", lambda: gp.log_likelihood(y))
    call("grad_log_likelihood", lambda: gp.grad_log_likelihood(y))
    if t_var is not None:
        call("predict_var", lambda: gp.predict(y, t_var, return_var=True))
    if t_cov is not None:
        call("predict_cov", lambda: gp.predict(y, t_cov, return_cov=True))
    return out, launches


def route_errors(results):
    """Errors of the float32 kernel and plain routes against the float64
    plain route, per quantity: {name: (kernel, plain, max |ref|)}."""
    ref = results["float64 plain"][0]
    errs = {}

    def add(name, get):
        r = np.asarray(get(ref), np.float64)
        e = [float(np.max(np.abs(np.asarray(get(results[k][0]), np.float64)
                                 - r)))
             for k in ("float32 kernel", "float32 plain")]
        errs[name] = (e[0], e[1], float(np.max(np.abs(r))))

    add("log-likelihood", lambda o: o["log_likelihood"])
    add("gradient", lambda o: o["grad_log_likelihood"])
    if "predict_var" in ref:
        add("predict mean (4096 points)", lambda o: o["predict_var"][0])
        add("predict variance", lambda o: o["predict_var"][1])
        add("predict mean (1024 points)", lambda o: o["predict_cov"][0])
        add("predict covariance", lambda o: o["predict_cov"][1])
    return errs


GP_PREDICTED = {"compute": (1, 0), "log_likelihood": (0, 0),
                "grad_log_likelihood": (1, 1), "predict_var": (1, 0),
                "predict_cov": (2, 0)}


def check_gp_launches(launches, route, what):
    """Each call's (forward, backward) launches: on the kernel route one
    forward per stationary leaf for each build (compute; the gradient's
    rebuild, plus its one backward; predict's cross matrix, and its prior
    matrix with return_cov), none on a plain route."""
    for name, got in launches.items():
        want = GP_PREDICTED[name] if route == "kernel" else (0, 0)
        check(got == want, "{0} {1}: launches (forward, backward) {2}, "
              "predicted {3}".format(what, name, got, want))


def run_gp_api(dev, card):
    """Phase 12: the BASELINE model at N = GP_N through compute,
    log_likelihood, grad_log_likelihood, predict (return_var at 4096
    points, return_cov at 1024) and a short L-BFGS-B fit, on the float64
    plain route (float64 under "auto"), the float32 plain route ("never")
    and the float32 kernel route ("auto"); then config #5's kernel at
    N = GP5_N, and the routing of "auto".  Returns the path's (forward,
    backward) launches: counts set to 0 just before the kernel route's
    calls and read just after its fit."""
    import torch
    from scipy.optimize import minimize
    from george_tpu_torch import config, kernels

    import george_tpu_torch as george

    f32, f64 = torch.float32, torch.float64
    x, y, yerr = chol16k_data()
    t_var = np.linspace(0, 10, GP_PREDICT_VAR)
    t_cov = np.linspace(0, 10, GP_PREDICT_COV)
    results = {}
    for label, dtype, route in (("float64 plain", f64, "auto"),
                                ("float32 plain", f32, "never")):
        config.pallas_covariance = route
        t0 = time.time()
        results[label] = gp_calls(baseline_gp(dev, dtype), x, y, yerr,
                                  t_var, t_cov)
        log("  {0} ('{1}'): ll {2!r} in {3:.2f} s".format(
            label, route, results[label][0]["log_likelihood"],
            time.time() - t0))
        check_gp_launches(results[label][1], "plain", label)
        torch.cuda.empty_cache()
    config.pallas_covariance = "auto"

    reset_cov_counts()
    gp = baseline_gp(dev, f32)
    t0 = time.time()
    results["float32 kernel"] = gp_calls(gp, x, y, yerr, t_var, t_cov)
    out = results["float32 kernel"][0]
    log("  float32 kernel ('auto'): ll {0!r} in {1:.2f} s".format(
        out["log_likelihood"], time.time() - t0))
    check_gp_launches(results["float32 kernel"][1], "kernel",
                      "float32 kernel")
    mu, var = out["predict_var"]
    muc, covm = out["predict_cov"]
    check(mu.shape == var.shape == (GP_PREDICT_VAR,) and
          covm.shape == (GP_PREDICT_COV, GP_PREDICT_COV) and
          all(np.all(np.isfinite(a)) for a in (mu, var, muc, covm)),
          "predict: finite mean and variance at {0} points, covariance "
          "{1}".format(GP_PREDICT_VAR, covm.shape))
    check_route(route_errors(results), "N={0}".format(GP_N))

    # A short fit of the reference's tutorial kind, from a perturbed start.
    p_start = gp.get_parameter_vector() + 0.5 * np.random.default_rng(
        5).standard_normal(len(gp))
    values = []

    def nll(v):
        values.append(gp.nll(v, y))
        return values[-1]

    t0 = time.time()
    res = minimize(nll, p_start, jac=lambda v: gp.grad_nll(v, y),
                   method="L-BFGS-B", options=dict(maxiter=FIT_ITERATIONS))
    torch.cuda.synchronize()
    path_launches = cov_counts()
    check(all(np.isfinite(values)) and res.fun <= values[0],
          "L-BFGS-B fit: {0} iterations, {1} objectives, all finite; NLL "
          "{2!r} -> {3!r} in {4:.2f} s; parameters {5}".format(
              res.nit, len(values), values[0], float(res.fun),
              time.time() - t0, np.round(res.x, 4)))
    log("  the path (float32 kernel route and the fit): {0} forward and "
        "{1} backward launches".format(*path_launches))
    del gp
    torch.cuda.empty_cache()

    # "auto" takes the kernel for float32 at N >= 1024 (2^20 entries) and
    # the plain route below it and for a blocked leaf.
    blocked = george.GP(1.0 * kernels.ExpSquaredKernel(1.0, block=[(0, 5)]),
                        white_noise=np.log(1e-3), device=dev, dtype=f32)
    for what, g, n, want in (
            ("float32 N=1024", baseline_gp(dev, f32), 1024, (1, 0)),
            ("float32 N=1000", baseline_gp(dev, f32), 1000, (0, 0)),
            ("float32 blocked leaf N=2048", blocked, 2048, (0, 0))):
        before = cov_counts()
        g.compute(x[:n], yerr[:n])
        torch.cuda.synchronize()
        after = cov_counts()
        got = (after[0] - before[0], after[1] - before[1])
        check(got == want, "'auto' {0}: compute launches {1}, predicted "
              "{2}".format(what, got, want))

    xd, yd, yerrd = config5_data(GP5_N)
    results5 = {}
    for label, dtype, route in (("float64 plain", f64, "auto"),
                                ("float32 plain", f32, "never"),
                                ("float32 kernel", f32, "auto")):
        config.pallas_covariance = route
        t0 = time.time()
        results5[label] = gp_calls(config5_gp(dev, dtype=dtype), xd, yd,
                                   yerrd)
        log("  config #5 {0} ('{1}'): ll {2!r}, gradient {3} in {4:.2f} s"
            .format(label, route, results5[label][0]["log_likelihood"],
                    np.round(results5[label][0]["grad_log_likelihood"], 4),
                    time.time() - t0))
        check_gp_launches(results5[label][1],
                          "kernel" if label == "float32 kernel" else "plain",
                          "config #5 " + label)
        torch.cuda.empty_cache()
    config.pallas_covariance = "auto"
    check_route(route_errors(results5), "config #5 N={0}".format(GP5_N))
    return path_launches


def run_sampler_density(dev):
    """Phase 13: ``build_gp_log_prob(method="dense")`` value and gradient
    over SAMPLER_CHAINS chains at N = SAMPLER_N (above the fused engine's
    envelope, so the plain density builds K under ``torch.func.vmap``) on
    a RationalQuadratic kernel (a radial parameter, so dp), on the three
    routes; the float32 kernel route is one batched forward and one batched
    backward."""
    import torch
    from george_tpu_torch import config, kernels
    from george_tpu_torch.samplers import build_gp_log_prob

    import george_tpu_torch as george

    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(0, 10, SAMPLER_N))
    y = np.sin(x) + 0.1 * rng.standard_normal(SAMPLER_N)
    gp = george.GP(1.0 * kernels.RationalQuadraticKernel(log_alpha=0.3,
                                                         metric=1.0),
                   white_noise=np.log(1e-2), fit_white_noise=True,
                   device=dev)
    thetas = gp.get_parameter_vector()[None] + 0.05 * rng.standard_normal(
        (SAMPLER_CHAINS, len(gp)))
    results = {}
    for label, dtype, route in (("float64 plain", torch.float64, "auto"),
                                ("float32 plain", torch.float32, "never"),
                                ("float32 kernel", torch.float32, "auto")):
        config.pallas_covariance = route
        lp, _ = build_gp_log_prob(gp, x, y, 0.1, method="dense", device=dev,
                                  dtype=dtype)
        th = torch.as_tensor(thetas, device=dev, dtype=dtype) \
            .requires_grad_(True)
        before = cov_counts()
        v = lp(th)
        g, = torch.autograd.grad(v.sum(), th)
        torch.cuda.synchronize()
        after = cov_counts()
        got = (after[0] - before[0], after[1] - before[1])
        want = (1, 1) if label == "float32 kernel" else (0, 0)
        check(lp.engine == "torch_dense_autograd" and got == want and
              bool(torch.all(torch.isfinite(v))) and
              bool(torch.all(torch.isfinite(g))),
              "{0} ('{1}'): engine {2}, launches (forward, backward) {3} "
              "(predicted {4}), finite values and gradients".format(
                  label, route, lp.engine, got, want))
        results[label] = ({"log_likelihood": v.detach().cpu().numpy(),
                           "grad_log_likelihood": g.cpu().numpy()}, got)
    config.pallas_covariance = "auto"
    check_route(route_errors(results), "sampler density B={0}".format(
        SAMPLER_CHAINS))


def cov_timing_inputs(dev):
    """The covariance kernels' timed shapes, float32: (label, leaf, p, A).
    N = GP_N with d = 1 (the BASELINE model, ExpSquared); N = GP5_N with
    d = 2 (config #5's Matern32 leaf on its two axes); the vmapped sampler
    density of phase 13, B = SAMPLER_CHAINS at N = SAMPLER_N (its
    RationalQuadratic leaf, d = 1, a radial parameter per chain), and
    config #5's leaf at the same B and N (d = 2); the RationalQuadratic
    leaf at N = GP5_N, where the dp tangents ride along."""
    import torch

    f32 = torch.float32
    leaves = dict(cov_leaves())
    rng = np.random.default_rng(17)
    x = chol16k_data()[0]
    xd = config5_data(GP5_N)[0][:, [0, 2]] * np.exp(
        -0.5 * np.log([1.0, 2.0]))
    xs = np.sort(rng.uniform(0, 10, SAMPLER_N))
    scale = np.exp(0.05 * rng.standard_normal((SAMPLER_CHAINS, 1, 1)))
    xs5 = config5_data(SAMPLER_N)[0][:, [0, 2]] * np.exp(
        -0.5 * np.log([1.0, 2.0]))
    rq = leaves["rational_quadratic d=1"]

    def t(v):
        return torch.as_tensor(v, device=dev, dtype=f32).contiguous()

    return [
        ("N={0} d=1".format(GP_N), leaves["exp_squared d=1"],
         t(np.zeros(0)), t(x[:, None])),
        ("N={0} d=2".format(GP5_N), leaves["matern32 d=2"], t(np.zeros(0)),
         t(xd)),
        ("B={0} N={1} d=1 NP=1".format(SAMPLER_CHAINS, SAMPLER_N), rq,
         t(0.3 + 0.05 * rng.standard_normal((SAMPLER_CHAINS, 1))),
         t(xs[None, :, None] * scale)),
        ("B={0} N={1} d=2".format(SAMPLER_CHAINS, SAMPLER_N),
         leaves["matern32 d=2"], t(np.zeros((SAMPLER_CHAINS, 0))),
         t(xs5[None] * scale)),
        ("N={0} d=1 NP=1".format(GP5_N), rq, t([0.3]),
         t(np.sort(rng.uniform(0, 10, GP5_N))[:, None])),
    ]


def time_cov_kernels(dev, card, plain=True, reps=20):
    """The covariance kernels (and, with ``plain``, their plain versions)
    at each shape of :func:`cov_timing_inputs`, medians over CUDA events
    beside their bounds.  Returns {label: (leaf, p, A, f_ms, fp_ms, fb, fby,
    b_ms, bp_ms, bb, bby)}; tools/cov_timing.py runs it against the package
    of another checkout."""
    import torch
    from george_tpu_torch.ops import cov

    f32 = torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timed = {}
    for label, leaf, p, A in cov_timing_inputs(dev):
        B = A.shape[0] if A.dim() == 3 else 1
        n = A.shape[-2]
        g = torch.randn(A.shape[:-2] + (n, n), generator=gen, device=dev,
                        dtype=f32)
        f_ms, f_min = median_ms(lambda: cov.stationary_cov_fwd(leaf, p, A, A),
                                reps=reps)
        b_ms, b_min = median_ms(
            lambda: cov.stationary_cov_bwd(leaf, p, A, A, g), reps=reps)
        fp_ms = bp_ms = None
        if plain:
            fp_ms = median_ms(lambda: cov.stationary_cov_torch(leaf, p, A, A),
                              reps=5, warmup=1)[0]
            bp_ms = median_ms(
                lambda: cov.stationary_cov_vjp_torch(leaf, p, A, A, g),
                reps=5, warmup=1)[0]
        fb, fby = cov_fwd_bound(leaf, n, n, B=B)
        bb, bby = cov_bwd_bound(leaf, n, n, B=B)
        if hasattr(cov, "bwd_plan"):
            layout = "{0} grid launches each; {1} bands x {2} strips of {3} " \
                "tiles, {4} resident blocks".format(
                    cov.bwd_grid_launches(leaf, f32, B, n, n),
                    *cov.bwd_plan(leaf, f32, B, n, n, dev))
        else:   # a package from before the one-pass backward
            layout = "grid launches not reported by this package"

        def plain_text(ms):
            return "not timed" if ms is None else "{0:.4f} ms".format(ms)

        log("  forward float32 {0}: median {1:.4f} ms (min {2:.4f}) over {3} "
            "launches; plain build {4}; bound {5:.4f} ms set by {6}; kernel "
            "at {7:.1%} of the bound; library call: none; on {8}".format(
                label, f_ms, f_min, reps, plain_text(fp_ms), fb, fby,
                fb / f_ms, card))
        log("  backward float32 {0}: median {1:.4f} ms (min {2:.4f}) over {3} "
            "calls ({4}); plain VJP {5}; bound {6:.4f} ms set by {7}; kernel "
            "at {8:.1%} of the bound; library call: none; on {9}".format(
                label, b_ms, b_min, reps, layout, plain_text(bp_ms), bb, bby,
                bb / b_ms, card))
        timed[label] = (leaf, p, A, f_ms, fp_ms, fb, fby, b_ms, bp_ms, bb, bby)
        del g
        torch.cuda.empty_cache()
    return timed


def time_cov(dev, card, path_launches, err_f, err_b):
    """Phase 14: the kernels and their plain versions at the paths' shapes
    (:func:`time_cov_kernels`), the kernels' float32 errors at N = GP_N,
    ``GP.compute`` at N = GP_N split into build, factor and the rest, and
    one ``grad_log_likelihood`` on each route.  Returns the kernels'
    entries of the JSON line."""
    import torch
    from george_tpu_torch import config
    from george_tpu_torch.ops import cov, linalg

    f32 = torch.float32
    timed = time_cov_kernels(dev, card)
    first = "N={0} d=1".format(GP_N)
    leaf, p, A = timed[first][:3]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    g = torch.randn((GP_N, GP_N), generator=gen, device=dev, dtype=f32)
    K = cov.stationary_cov_fwd(leaf, p, A, A)
    grads = cov.stationary_cov_bwd(leaf, p, A, A, g)
    torch.cuda.synchronize()
    K_ref = cov.stationary_cov_torch(leaf, p.double(), A.double(), A.double())
    err_f = max(err_f, check_k32(K, K_ref, "forward " + first))
    del K, K_ref
    refs = cov.stationary_cov_vjp_torch(
        leaf, p.double(), A.double(), A.double(), g.double())
    for name, a, b in zip(("dp", "dA1", "dA2"), grads, refs):
        err_b = max(err_b, check_grad32(a, b, "backward {0} {1}".format(
            first, name)))
    del grads, refs, g
    torch.cuda.empty_cache()

    x, y, yerr = chol16k_data()
    # GP.compute at N = GP_N, float32: build (the kernel and the diagonal),
    # factor (cholesky_ex alone) and the rest (the NaN guard, the
    # log-determinant, host transfers), beside the plain route's compute.
    # One grad_log_likelihood (build, factor, K^-1 and the backward through
    # the Cholesky and the covariance VJP), the same way.
    gp = baseline_gp(dev, f32)
    walls, grad_walls = {}, {}
    for route in ("never", "auto", "auto", "never"):
        config.pallas_covariance = route
        gp.compute(x, yerr)
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.time()
            gp.compute(x, yerr)
            torch.cuda.synchronize()
            walls.setdefault(route, []).append(1e3 * (time.time() - t0))
        gp.grad_log_likelihood(y)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            gp.grad_log_likelihood(y)
            torch.cuda.synchronize()
            grad_walls.setdefault(route, []).append(
                1e3 * (time.time() - t0))
    config.pallas_covariance = "auto"
    log("  grad_log_likelihood float32 N={0}: median {1:.2f} ms on the "
        "kernel route, {2:.2f} ms on the plain route (host clock, 6 calls "
        "each); on {3}".format(GP_N, float(np.median(grad_walls["auto"])),
                               float(np.median(grad_walls["never"])), card))
    node = gp.kernel.spec_node()
    theta = torch.as_tensor(gp.kernel.get_parameter_vector(
        include_frozen=True), device=dev, dtype=f32)
    xt = torch.as_tensor(x[:, None], device=dev, dtype=f32)
    noise = torch.as_tensor(yerr ** 2 + np.exp(gp.white_noise.get_value(x)),
                            device=dev, dtype=f32)
    with torch.no_grad():
        build_ms, _ = median_ms(lambda: linalg.build_K(node, theta, xt,
                                                       noise), reps=10)
        K = linalg.build_K(node, theta, xt, noise)
        chol_ms, chol_min = median_ms(lambda: torch.linalg.cholesky_ex(K),
                                      reps=10)
    compute_ms = float(np.median(walls["auto"]))
    log("  GP.compute float32 N={0} (build + factor + logdet): median "
        "{1:.2f} ms on the kernel route, {2:.2f} ms on the plain route "
        "(host clock, 10 calls each); build {3:.4f} ms (CUDA events), "
        "cholesky_ex alone {4:.2f} ms (min {5:.2f}), rest {6:.2f} ms; "
        "cholesky_ex at {7:.1f} TFLOP/s (N^3 / 3); on {8}".format(
            GP_N, compute_ms, float(np.median(walls["never"])), build_ms,
            chol_ms, chol_min, compute_ms - build_ms - chol_ms,
            GP_N ** 3 / 3.0 / (chol_ms * 1e-3) / 1e12, card))
    del K, gp
    torch.cuda.empty_cache()

    f_ms, fp_ms, fb, fby, b_ms, bp_ms, bb, bby = timed[first][3:]
    entry = {"route": "cuda",
             "source": "george_tpu_torch/csrc/stationary_cov.cu",
             "library_ms": None}
    return [dict(entry, name="stationary_cov_fwd",
                 replaces="george_tpu/ops/pallas_cov.py:66",
                 launches=path_launches[0], max_abs_err=err_f, ms=f_ms,
                 plain_ms=fp_ms, bound_ms=fb, bound_by=fby),
            dict(entry, name="stationary_cov_bwd",
                 replaces="george_tpu/ops/pallas_cov.py:71",
                 launches=path_launches[1], max_abs_err=err_b, ms=b_ms,
                 plain_ms=bp_ms, bound_ms=bb, bound_by=bby)]


# -- slice 4: the blocked dense engine and the batched product ------------------

def spine_ops(n=128):
    """Operations of one chain's Cholesky and inverse, counted as a
    column-by-column factor and inverse do them: the Cholesky (per pivot a
    sqrt, a log, the column's divisions and the trailing update's
    multiply-adds) and the inverse (per column a reciprocal, the rows'
    multiply-adds and scalings).  The tiled kernel (csrc/tile_chol.cuh)
    does ~40% more: whole diagonal tiles and the products by T_jj."""
    chol = sum(2 + (n - k - 1) + (n - k - 1) * (n - k) for k in range(n))
    trtri = sum(1 + (n - j - 1) * (n - j) + (n - j - 1) for j in range(n))
    return chol + trtri


def spine_bytes(B, itemsize=4, n=128):
    """S's lower triangle read once (nothing reads above it), T and logdet
    written once."""
    return itemsize * B * (n * (n + 1) // 2 + n * n + 1)


def spine_bound(B, itemsize=4, n=128):
    """The bytes above and the operations above."""
    return _bound(spine_bytes(B, itemsize, n), B * spine_ops(n))


def mm_bound(B, n):
    """float32: A and B read once, O written once; 2 B N^3 operations three
    times over (the kernel's 3xTF32 products) at the TF32 peak."""
    return _bound(4 * 3 * B * n * n, 3 * 2.0 * B * n ** 3, PEAK_TF32)


def mxu_instances():
    """(label, dtype, instance) of the spine and batched-product kernels."""
    import torch
    from george_tpu_torch.ops import batched_mm, dense_mxu

    return [(label, dt, make(dt)) for label, make in (
        ("dense spine", dense_mxu.spine_instance),
        ("batched mmT", batched_mm.instance))
        for dt in (torch.float32, torch.float64)]


def mxu_smem_lines():
    """The shared memory a block of the spine and batched-product kernels
    takes (dynamic, so not in the ptxas lines), from their builds."""
    import ctypes
    from george_tpu_torch import _build

    lines = []
    for label, dt, inst in mxu_instances():
        lib = _build.load(inst)
        cfg = (ctypes.c_int * 5)()
        fn = (lib.dense_spine_config if label == "dense spine"
              else lib.batched_mmT_config)
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = None
        fn(cfg)
        what = ("{0} bytes of shared memory a chain, built for {1} chains "
                "an SM".format(cfg[3], cfg[4]) if label == "dense spine" else
                "{0} bytes of shared memory a block with the 128-wide "
                "tile, {1} with the 64-wide".format(cfg[3], cfg[4]))
        lines.append("  {0} {1}: {2}".format(label, str(dt).split(".")[-1],
                                             what))
    return lines


def mxu_lp(gp, x, y, yerr, dev, **kw):
    """``build_gp_log_prob(method="dense")`` with the blocked engine opted
    in: (log_prob, theta0), the engine checked to be cuda_dense_mxu."""
    from george_tpu_torch import config
    from george_tpu_torch.samplers import build_gp_log_prob

    config.dense_mxu_sampling = True
    try:
        lp, theta0 = build_gp_log_prob(gp, x, y, yerr, method="dense",
                                       device=dev, **kw)
    finally:
        config.dense_mxu_sampling = False
    check(lp.engine == "cuda_dense_mxu", "N={0}: engine {1}".format(
        len(x), lp.engine))
    return lp, theta0


def sliced(fn, theta):
    """``fn`` over slices of MXU_SLICE chains, concatenated."""
    import torch

    outs = [fn(theta[i:i + MXU_SLICE])
            for i in range(0, theta.shape[0], MXU_SLICE)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def first_block(vg, theta):
    """The engine's first 128 x 128 diagonal block of K for each chain."""
    import torch

    n_scalar = vg.n_mean + vg.n_wn
    with torch.no_grad():
        K = vg.build(theta[:, n_scalar:],
                     theta[:, vg.n_mean] if vg.n_wn else None,
                     vg.data(theta))
    return K[:, :128, :128].contiguous()


def check_spine(dev, vg, theta):
    """Phase 15a: the spine kernel against ``spine_torch`` on the engine's
    first diagonal blocks (config #5 at N = 256) over SPINE_CHAINS chains,
    four of them made non positive definite.  float64 within 1e-9 of each
    chain's largest |T| and 1e-9 |logdet|; float32 T within twice the
    float32 plain version's error (plus 4 ulps of |T|) and logdet within
    the reference's kernel tolerance 1e-4 |logdet| + 1e-2.  Returns (S64,
    the float32 kernel's largest error)."""
    import torch
    from george_tpu_torch.ops import dense_mxu

    S = first_block(vg, theta)
    B = S.shape[0]
    bad_rows = [B // 300, B // 20, B * 4 // 5]
    for b in bad_rows:
        S[b, 64, 64] = -1.0                 # a negative pivot at 64
    S[B - 96, 0, 0] = 0.0                   # a zero first pivot
    bad = torch.zeros(B, dtype=torch.bool, device=dev)
    bad[bad_rows + [B - 96]] = True
    T_ref, ld_ref = dense_mxu.spine_torch(S)
    Tp, _ = dense_mxu.spine_torch(S.float())
    ok = ~bad
    scale = T_ref[ok].abs().amax(dim=(1, 2))
    p_err = float(((Tp.double()[ok] - T_ref[ok]).abs().amax(dim=(1, 2))
                   / scale).max())
    err32 = 0.0
    for dtype in (torch.float64, torch.float32):
        launches = dense_mxu.spine.launches
        T, ld = dense_mxu.spine(S.to(dtype).contiguous())
        torch.cuda.synchronize()
        T, ld = T.double(), ld.double()
        nan_ok = bool(torch.equal(torch.isnan(ld), bad)) and \
            bool(torch.all(torch.isnan(T[bad]))) and \
            bool(torch.all(torch.isfinite(T[ok])))
        t_err = (T[ok] - T_ref[ok]).abs().amax(dim=(1, 2)) / scale
        l_err = (ld[ok] - ld_ref[ok]).abs()
        if dtype == torch.float64:
            good = bool(torch.all(t_err <= 1e-9)) and \
                bool(torch.all(l_err <= 1e-9 * ld_ref[ok].abs()))
        else:
            good = float(t_err.max()) <= 2 * p_err + 4 * EPS32 and \
                bool(torch.all(l_err <= 1e-4 * ld_ref[ok].abs() + 1e-2))
            err32 = max(float((T[ok] - T_ref[ok]).abs().max()),
                        float(l_err.max()))
        check(nan_ok and good and dense_mxu.spine.launches == launches + 1,
              "spine {0} B={1}: max |T err| / max |T| {2:.3e} (float32 "
              "plain version {3:.3e}), max |logdet err| {4:.3e} (|logdet| "
              "up to {5:.4g}); NaN exactly on the {6} non-PD chains".format(
                  str(dtype).split(".")[-1], S.shape[0], float(t_err.max()),
                  p_err, float(l_err.max()), float(ld_ref[ok].abs().max()),
                  int(bad.sum())))
        # A chain count that fills no whole wave of the card: each chain is
        # one block, so the first SPINE_RAGGED chains come out bit for bit.
        Tr, ldr = dense_mxu.spine(S[:SPINE_RAGGED].to(dtype).contiguous())
        torch.cuda.synchronize()
        check(bool(torch.equal(Tr.double().nan_to_num(),
                               T[:SPINE_RAGGED].nan_to_num())) and
              bool(torch.equal(ldr.double().nan_to_num(),
                               ld[:SPINE_RAGGED].nan_to_num())),
              "spine {0} B={1}: the same bits as the first {1} chains of "
              "the B={2} call".format(str(dtype).split(".")[-1],
                                      SPINE_RAGGED, S.shape[0]))
    return S, err32


def check_mm(dev):
    """Phase 15b: the batched product against its plain version at the
    benchmark's inputs (B = MM_B, N = MM_N), float32 at each chain count
    and float64.  Returns the float32 kernel's largest error."""
    import torch
    from george_tpu_torch.ops import batched_mm

    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((MM_B, MM_N, MM_N)), device=dev)
    b = torch.as_tensor(rng.standard_normal((MM_B, MM_N, MM_N)), device=dev)
    ref = batched_mm.batched_mmT_torch(a, b)
    scale = torch.linalg.norm(a, dim=2)[:, :, None] \
        * torch.linalg.norm(b, dim=2)[:, None, :]
    a32, b32 = a.float(), b.float()
    p_err = float(((batched_mm.batched_mmT_torch(a32, b32).double() - ref)
                   .abs() / scale).max())
    err32 = 0.0
    for dtype, chains in ((torch.float64, (1, 8)),
                          (torch.float32, batched_mm.CHAINS_PER_BLOCK)):
        for c in chains:
            out = batched_mm.batched_mmT(a.to(dtype), b.to(dtype), c)
            torch.cuda.synchronize()
            e = (out.double() - ref).abs()
            rel = float((e / scale).max())
            if dtype == torch.float64:
                good = rel <= 1e-12
            else:
                good = rel <= MM_ULPS * EPS32
                err32 = max(err32, float(e.max()))
            check(good and bool(torch.all(torch.isfinite(out))),
                  "batched mmT {0} B={1} N={2}, {3} chains a block: max "
                  "|err| / (|a_i| |b_j|) {4:.3e} ({5:.2f} float32 ulps; the "
                  "float32 plain version {6:.2f})".format(
                      str(dtype).split(".")[-1], MM_B, MM_N, c, rel,
                      rel / EPS32, p_err / EPS32))
    return err32


def check_mxu_case(vg, theta, what, panels):
    """The engine in float32 and float64 on the card against float64 with
    the plain spine: float64 at rtol 1e-9, float32 at the reference's
    kernel tolerances; NaN rows the same in all.  One spine launch per
    panel per call.  Returns the float32 errors (ll, grad)."""
    import torch
    from george_tpu_torch.ops import dense_mxu

    t64 = theta.to(torch.float64).contiguous()
    ll_ref, g_ref = sliced(lambda t: vg.value_and_grad(
        t, spine_fn=dense_mxu.spine_torch), t64)
    failed = torch.isnan(ll_ref)
    ok = ~failed
    errs = {}
    for dtype in (torch.float64, torch.float32):
        launches = dense_mxu.spine.launches
        if dtype == torch.float64:
            ll, g = sliced(vg, t64)
            calls = -(-theta.shape[0] // MXU_SLICE)
        else:
            ll, g = vg(theta.to(dtype).contiguous())
            calls = 1
        torch.cuda.synchronize()
        launched = dense_mxu.spine.launches - launches
        ll, g = ll.double(), g.double()
        same_failures = bool(torch.equal(torch.isnan(ll), failed))
        lr, gr, lk, gk = ll_ref[ok], g_ref[ok], ll[ok], g[ok]
        finite = bool(torch.all(torch.isfinite(lk)) and
                      torch.all(torch.isfinite(gk)))
        e_ll, e_g = (lk - lr).abs(), (gk - gr).abs()
        if dtype == torch.float64:
            good = bool(torch.all(e_ll <= 1e-9 * lr.abs())) and \
                bool(torch.all(e_g <= 1e-9 * gr.abs() + 1e-9))
        else:
            good = within_reference_tolerance(lk, gk, lr, gr)
            errs = (float(e_ll.max()), float(e_g.max()))
        check(finite and good and same_failures and
              launched == panels * calls,
              "{0} {1}: max |ll err| {2:.3e}, max |grad err| {3:.3e} (|ll| "
              "up to {4:.4g}); {5} spine launches ({6} panels x {7} calls)"
              "{8}".format(what, str(dtype).split(".")[-1],
                           float(e_ll.max()), float(e_g.max()),
                           float(lr.abs().max()), launched, panels, calls,
                           "; {0} failed factorizations in all".format(
                               int(failed.sum())) if failed.any() else ""))
    return errs


def mxu_trees():
    """(label, GP keywords, parameter to freeze, input dimension) of the
    engine's tree cases: the general metric and tests/test_dense_mxu.py's
    sum with a frozen parameter."""
    from george_tpu_torch import kernels as k

    wn = dict(white_noise=np.log(1e-3), fit_white_noise=True)
    return (
        ("general metric", dict(kernel=1.0 * k.ExpSquaredKernel(
            metric=[[1.0, 0.1], [0.1, 2.0]], ndim=2), **wn), None, 2),
        ("sum, frozen parameter", dict(kernel=1.0 * k.Matern32Kernel(
            metric=[1.0, 2.0], ndim=3, axes=[0, 2])
            + 0.5 * k.ExpSquaredKernel(metric=2.0, ndim=3, axes=[1]), **wn),
         "kernel:k2:k1:log_constant", 3),
    )


def run_mxu_engine(dev):
    """Phases 15-16: the spine and the batched product against their plain
    versions, then the engine through ``build_gp_log_prob`` at every shape
    of MXU_SHAPES, on the tree cases, on rejected points, once with TF32
    allowed, and the float64 engine against the plain autograd density.
    Returns (spine float32 error, batched product float32 error, the
    engine at config #5 N = 256: (gp, vg, theta float32))."""
    import torch
    import george_tpu_torch as george
    from george_tpu_torch import kernels as k

    gp5 = config5_gp(dev)
    engines = {}
    for n, chains in MXU_SHAPES:
        x, y, yerr = config5_data(n)
        lp, _ = mxu_lp(gp5, x, y, yerr, dev)
        th = torch.as_tensor(full_thetas(gp5, lp.dense_mxu_vg.active, 13,
                                         chains, 0.2), device=dev)
        engines[n] = (lp, th)

    log("  15a: the spine kernel")
    lp256, th256 = engines[256]
    S, spine_err = check_spine(dev, lp256.dense_mxu_vg, th256)
    del S
    log("  15b: the batched product")
    mm_err = check_mm(dev)
    torch.cuda.empty_cache()

    log("  16: the engine against float64 with the plain spine")
    for n, chains in MXU_SHAPES:
        lp, th = engines[n]
        check_mxu_case(lp.dense_mxu_vg, th, "config #5 N={0} B={1}".format(
            n, chains), lp.dense_mxu_vg.panels)
        torch.cuda.empty_cache()
    for label, kw, freeze, ndim in mxu_trees():
        g = george.GP(device=dev, **kw)
        if freeze:
            g.freeze_parameter(freeze)
        x, y, yerr = config5_data(MXU_TREE_N, seed=31)
        lp, _ = mxu_lp(g, x[:, :ndim], y, yerr, dev)
        vg = lp.dense_mxu_vg
        th = torch.as_tensor(full_thetas(g, vg.active, 37, MXU_TREE_CHAINS,
                                         0.15), device=dev)
        check_mxu_case(vg, th, "{0} N={1} B={2} active={3}".format(
            label, MXU_TREE_N, MXU_TREE_CHAINS, vg.active), vg.panels)

    # Rejected points through the entry point's batched_value_and_grad: a
    # log amplitude of 1000 (the factorization fails) and a metric out of
    # its bounds read -inf with a zero gradient.
    gb = george.GP(2.0 * k.ExpSquaredKernel(
        metric=1.0, metric_bounds=[(-2.0, 2.0)], ndim=3, axes=[1]),
        white_noise=np.log(1e-3), fit_white_noise=True, device=dev)
    x, y, yerr = config5_data(200, seed=41)
    lpb, thb = mxu_lp(gb, x, y, yerr, dev, dtype=torch.float32)
    rows = torch.stack([thb, thb, thb])
    rows[1, -1] = 5.0
    rows[2, 1] = 1000.0
    lp_b, g_b = lpb.batched_value_and_grad(rows)
    full = torch.as_tensor(np.tile(gb.get_parameter_vector(
        include_frozen=True), (3, 1)), device=dev, dtype=torch.float32)
    full[:, 1:] = rows
    ll_raw, _ = lpb.dense_mxu_vg(full)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lp_b[0])) and
          bool(torch.all(torch.isneginf(lp_b[1:]))) and
          bool(torch.all(g_b[1:] == 0)) and bool(torch.isnan(ll_raw[2])),
          "rejected points: out of bounds and a failed factorization read "
          "-inf with a zero gradient (the engine's own ll NaN at the "
          "latter)")

    # TF32 allowed globally: the engine scopes full FP32 for its call, so
    # its results carry the same bits, and the caller's switch survives.
    vg256 = lp256.dense_mxu_vg
    t32 = th256.float().contiguous()
    m = torch.backends.cuda.matmul
    m.allow_tf32 = True
    try:
        l_tf, g_tf = vg256(t32)
        after = m.allow_tf32
    finally:
        m.allow_tf32 = False
    l_ie, g_ie = vg256(t32)
    torch.cuda.synchronize()
    check(bool(torch.equal(l_tf, l_ie)) and bool(torch.equal(g_tf, g_ie))
          and after is True,
          "TF32 allowed globally: the engine's float32 results are the same "
          "bits, and allow_tf32 reads True again after the call")

    # The float64 engine against the plain density (one Cholesky, autograd
    # through it) on the entry point's log_prob.
    lpp, _ = mxu_lp(gp5, *config5_data(256), dev)
    tha = th256[:256, list(vg256.active)].contiguous()
    lp_k, g_k = lpp.batched_value_and_grad(tha)
    th_req = tha.clone().requires_grad_(True)
    lp_p = lpp(th_req)
    g_p, = torch.autograd.grad(lp_p.sum(), th_req)
    lp_p = lp_p.detach()
    check(bool(torch.all((lp_k - lp_p).abs() <= 1e-9 * lp_p.abs())) and
          bool(torch.all((g_k - g_p).abs() <= 1e-9 * g_p.abs() + 1e-9)),
          "float64 engine against the plain autograd density, config #5 "
          "N=256 B=256: max |lp err| {0:.3e}, max |grad err| {1:.3e}".format(
              float((lp_k - lp_p).abs().max()),
              float((g_k - g_p).abs().max())))
    del engines
    torch.cuda.empty_cache()
    return spine_err, mm_err, (gp5, vg256, t32)


def run_fidelity(dev, card):
    """Phase 17: ChEES over config #5's posterior at N = FID_N, FID_CHAINS
    chains, float32, on the blocked engine (dense_mxu_sampling on) and on
    the fused engine (off), each from its own seed and start, so that the
    two runs are independent draws of one posterior (from one seed and
    start the chains would keep nearly the same trajectories, and the
    comparison would re-measure the value+gradient agreement of phase 16).
    Gates: each run divergences < 1% and split R-hat < 1.01; the two
    posterior means within 5 combined Monte Carlo standard errors and the
    stds within 10%.  Returns the spine's launches in the blocked engine's
    run."""
    import torch
    from george_tpu_torch import config
    from george_tpu_torch.ops import dense, dense_mxu
    from george_tpu_torch.samplers import (build_gp_log_prob,
                                           effective_sample_size,
                                           split_rhat)

    x, y, yerr = config5_data(FID_N)
    gp5 = config5_gp(dev)
    prior = bench_prior(gp5, dev, torch.float32)
    runs = {}
    for label, switch, engine, counter, seed in (
            ("blocked", True, "cuda_dense_mxu", dense_mxu.spine, 2),
            ("fused", False, "cuda_dense", dense.dense_vg, 1)):
        config.dense_mxu_sampling = switch
        try:
            lp, theta0 = build_gp_log_prob(gp5, x, y, yerr, method="dense",
                                           log_prior=prior, device=dev,
                                           dtype=torch.float32)
        finally:
            config.dense_mxu_sampling = False
        check(lp.engine == engine, "{0} run: engine {1}".format(
            label, lp.engine))
        z0 = theta0 + 0.1 * torch.as_tensor(
            np.random.default_rng(seed).standard_normal(
                (FID_CHAINS, len(theta0))), device=dev, dtype=theta0.dtype)
        (res, seconds, launches), = run_chees(
            lp, z0, (seed,), counter, dev, num_warmup=WARMUP,
            num_samples=FID_SAMPLES, num_leapfrog=FID_MAX_LEAPFROG,
            block_size=BLOCK, warmup_block_size=BLOCK)
        per_call = 2 if label == "blocked" else 1
        samples = res.samples.double()
        div = float(res.diverging.double().mean())
        rhat = float(split_rhat(samples).max())
        ess = effective_sample_size(samples)
        check(launches == per_call * res.num_evaluations and
              bool(torch.all(torch.isfinite(res.samples))) and
              div < 0.01 and rhat < 1.01,
              "{0} engine: {1} kernel launches for {2} value+gradient calls, "
              "divergence fraction {3:.5f} < 0.01, max split R-hat {4:.5f} < "
              "1.01, min ESS {5:.1f}, {6:.2f} s ({7:.2f} leapfrogs per draw, "
              "step size {8:.4f}); on {9}".format(
                  label, launches, res.num_evaluations, div, rhat,
                  float(ess.min()), seconds,
                  float(res.n_leapfrog.double().mean()),
                  float(res.step_size), card))
        flat = samples.reshape(-1, samples.shape[-1])
        runs[label] = (flat.mean(0), flat.std(0), flat.std(0) /
                       torch.sqrt(ess), launches)
    (m_b, s_b, se_b, launches), (m_f, s_f, se_f, _) = runs["blocked"], \
        runs["fused"]
    gap = (m_b - m_f).abs()
    bound = 5.0 * torch.sqrt(se_b ** 2 + se_f ** 2)
    ratio = s_b / s_f
    for label, (mean, std) in list(TPU_FIDELITY.items()) + [
            ("cuda_dense_mxu (H100)", (m_b.tolist(), s_b.tolist())),
            ("cuda_dense (H100)", (m_f.tolist(), s_f.tolist()))]:
        log("  {0:24s} mean {1}  std {2}".format(
            label, " ".join("{0:8.4f}".format(v) for v in mean),
            " ".join("{0:7.4f}".format(v) for v in std)))
    check(bool(torch.all(gap <= bound)) and
          bool(torch.all((ratio - 1).abs() <= 0.10)),
          "posterior of the blocked engine against the fused engine: mean "
          "gaps {0} within 5 combined MC standard errors {1} ({2} sd of the "
          "fused run); std ratios {3} within 10%".format(
              np.round(gap.cpu().numpy(), 5), np.round(bound.cpu().numpy(), 5),
              np.round((gap / s_f).cpu().numpy(), 4),
              np.round(ratio.cpu().numpy(), 4)))
    return launches


def load_file(path, name):
    """A script of the checkout as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_tool(name):
    """A script of tools/ as a module."""
    return load_file(os.path.join(HERE, "tools", name + ".py"),
                     "tool_" + name)


def run_batched_mm(card):
    """Phase 18: tools/batched_mm.py's measurement at B = MM_B, N = MM_N,
    the kernel's launch count set to 0 just before and read just after.
    Returns ({name: (ms, TFLOP/s)}, launches)."""
    from george_tpu_torch.ops import batched_mm

    tool = load_tool("batched_mm")
    batched_mm.batched_mmT.launches = 0
    lines = tool.measure(MM_B, MM_N, MM_REP)
    launches = batched_mm.batched_mmT.launches
    kernels = [k for k in lines if k.startswith("kernel")]
    check(launches == (MM_REP + 1) * len(kernels),
          "tools/batched_mm.py: {0} kernel launches ({1} chain counts x {2} "
          "repetitions + 1 warm-up)".format(launches, len(kernels), MM_REP))
    for name, (ms, tflops) in lines.items():
        log("  {0:12s}: {1:7.3f} ms  {2:6.2f} TFLOP/s (B={3}, N={4}; on {5})"
            .format(name, ms, tflops, MM_B, MM_N, card))
    return lines, launches


def time_mxu(dev, card, engine, mm_lines):
    """Phase 19: the spine at SPINE_CHAINS (kernel, plain version, the
    two-call library pair), the engine's float32 value+gradient at config
    #5 N = 256 split into its stages, the fused engine at the same shape,
    and the batched product's plain version beside its kernel and library
    times.  Returns the timing of (spine, batched product) for the JSON
    line."""
    import torch
    from george_tpu_torch import config
    from george_tpu_torch.ops import batched_mm, dense_mxu
    from george_tpu_torch.samplers import build_gp_log_prob

    gp5, vg, t32 = engine
    S = first_block(vg, t32)
    eye = torch.eye(128, device=dev)
    sp_ms, sp_min = median_ms(lambda: dense_mxu.spine(S), reps=20)
    sp_plain, _ = median_ms(lambda: dense_mxu.spine_torch(S), reps=10)
    sp_lib, _ = median_ms(lambda: torch.linalg.solve_triangular(
        torch.linalg.cholesky_ex(S)[0], eye.expand_as(S), upper=False),
        reps=10)
    sp_bound, sp_by = spine_bound(S.shape[0])
    S64 = S.double()
    sp64_ms, _ = median_ms(lambda: dense_mxu.spine(S64), reps=10)
    sp64_plain, _ = median_ms(lambda: dense_mxu.spine_torch(S64), reps=10)
    sp64_lib, _ = median_ms(lambda: torch.linalg.solve_triangular(
        torch.linalg.cholesky_ex(S64)[0], eye.double().expand_as(S64),
        upper=False), reps=10)
    sp64_bound, sp64_by = spine_bound(S.shape[0], 8)
    log("  spine float64 B={0}: median {1:.4f} ms over 10 launches; plain "
        "version {2:.4f} ms; library pair {3:.4f} ms (kernel {4:.2f}x "
        "faster); bound {5:.4f} ms set by {6}; kernel at {7:.1%} of the "
        "bound; on {8}".format(
            S.shape[0], sp64_ms, sp64_plain, sp64_lib, sp64_lib / sp64_ms,
            sp64_bound, sp64_by, sp64_bound / sp64_ms, card))
    del S64
    log("  spine float32 B={0}: median {1:.4f} ms (min {2:.4f}) over 20 "
        "launches; plain version {3:.4f} ms; library pair cholesky_ex + "
        "solve_triangular {4:.4f} ms (kernel {5:.2f}x faster); bound "
        "{6:.4f} ms set by {7} ({8} operations a chain); kernel at {9:.1%} "
        "of the bound; on {10}".format(
            S.shape[0], sp_ms, sp_min, sp_plain, sp_lib, sp_lib / sp_ms,
            sp_bound, sp_by, spine_ops(), sp_bound / sp_ms, card))
    del S

    stages = {}
    for _ in range(6):
        marks = []

        def hook(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e))

        start = torch.cuda.Event(enable_timing=True)
        start.record()
        vg.value_and_grad(t32, stage=hook)
        torch.cuda.synchronize()
        prev = start
        for name, e in marks:
            stages.setdefault(name, []).append(prev.elapsed_time(e))
            prev = e
    split = {k: float(np.median(v[1:])) for k, v in stages.items()}
    total = sum(split.values())
    mx_ms, _ = median_ms(lambda: vg(t32), reps=10)
    config.dense_mxu_sampling = False
    lpd, _ = build_gp_log_prob(gp5, *config5_data(FID_N), method="dense",
                               device=dev)
    check(lpd.engine == "cuda_dense", "fused engine at N={0}: {1}".format(
        FID_N, lpd.engine))
    fd_ms, _ = median_ms(lambda: lpd.dense_vg(t32), reps=10)
    log("  blocked engine float32 value+gradient B={0} N={1}: median {2:.3f} "
        "ms over 10 calls; stages (median of 5) {3} = {4:.3f} ms; the fused "
        "engine (cuda_dense) at the same shape {5:.3f} ms; on {6}".format(
            t32.shape[0], FID_N, mx_ms, ", ".join(
                "{0} {1:.3f} ms ({2:.0%})".format(k, v, v / total)
                for k, v in split.items()), total, fd_ms, card))

    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((MM_B, MM_N, MM_N)), device=dev,
                        dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((MM_B, MM_N, MM_N)), device=dev,
                        dtype=torch.float32)
    mm_plain, _ = median_ms(lambda: batched_mm.batched_mmT_torch(a, b),
                            reps=20)
    mm_b, mm_by = mm_bound(MM_B, MM_N)
    lib_ms = mm_lines["matmul"][0]
    for c in batched_mm.CHAINS_PER_BLOCK:
        ms = mm_lines["kernel{0}".format(c)][0]
        log("  batched mmT float32 B={0} N={1}, {2} chains a block: {3:.4f} "
            "ms (torch.matmul {4:.4f} ms, kernel {5:.2f}x faster); bound "
            "{6:.4f} ms set by {7}; kernel at {8:.1%} of the bound; on "
            "{9}".format(MM_B, MM_N, c, ms, lib_ms, lib_ms / ms, mm_b,
                         mm_by, mm_b / ms, card))
    log("  batched mmT plain version (einsum) {0:.4f} ms; on {1}".format(
        mm_plain, card))
    return ((sp_ms, sp_plain, sp_lib, sp_bound, sp_by),
            (mm_lines["kernel1"][0], mm_plain, lib_ms, mm_b, mm_by))


# -- the phases ----------------------------------------------------------------

def run_nuts(phase, log_prob, z0, chees_runs, dense_lp, zd, kernel_ms, dev,
             card):
    """Phases 20-22: NUTS and HMC over the main path's log_prob and z0
    (phase 4's), against phase 4's ChEES runs, and NUTS over the dense
    path's log_prob and zd (phase 7's).  Returns the Kalman kernel's
    launches in the NUTS leg's first run and the dense path's NUTS
    result."""
    import torch
    from george_tpu_torch.ops import dense, kalman

    t_run = time.time()
    chains = z0.shape[0]
    phase("20: the NUTS leg over {0} chains, max depth {1}, "
          "trajectory-persistent".format(chains, NUTS_DEPTH))
    nruns = run_sampler(log_prob, z0, (1, 2), kalman.kalman_vg, dev, "nuts",
                        max_depth=NUTS_DEPTH, persistent=True,
                        num_warmup=WARMUP, num_samples=NUTS_SAMPLES,
                        block_size=NUTS_SAMPLES, warmup_block_size=BLOCK)
    for seed, r in zip((1, 2), nruns):
        nuts_gates(r, seed, card)
        sampler_split(r, kernel_ms, chains, card, "seed {0}".format(seed))
    means_agree([r[0] for r in nruns])
    posteriors_agree(nruns[0][0], chees_runs[0],
                     "NUTS (seed 1) against ChEES (phase 4, seed 1)")

    phase("21: per-draw NUTS against persistent NUTS, {0} chains".format(
        chains))
    (pd,) = run_sampler(log_prob, z0, (3,), kalman.kalman_vg, dev, "nuts",
                        max_depth=NUTS_DEPTH, persistent=False,
                        num_warmup=WARMUP, num_samples=PER_DRAW_SAMPLES,
                        block_size=PER_DRAW_SAMPLES, warmup_block_size=BLOCK)
    res = pd[0]
    check(pd[2] == res.num_evaluations and
          bool(torch.all(torch.isfinite(res.samples))),
          "per-draw: kernel launches {0} == value+gradient calls {1}, all "
          "draws finite".format(pd[2], res.num_evaluations))
    posteriors_agree(res, nruns[0][0], "per-draw NUTS (seed 3, {0} draws) "
                     "against persistent NUTS (seed 1)".format(
                         PER_DRAW_SAMPLES), stds=False)
    leaps = [float(r.n_leapfrog.double().mean()) for r in (res, nruns[0][0])]
    check(abs(leaps[0] - leaps[1]) <= 0.10 * leaps[1],
          "leapfrogs per draw, per-draw {0:.3f} against persistent {1:.3f}: "
          "within 10%".format(*leaps))
    sampler_split(pd, kernel_ms, chains, card, "per-draw, seed 3")
    for what, (r, n) in (("per-draw", (pd, PER_DRAW_SAMPLES)),
                         ("persistent", (nruns[0], NUTS_SAMPLES))):
        log("  {0}: sampling wall {1:.2f} ms a draw ({2} draws, {3:.1f} "
            "iterations a draw); on {4}".format(
                what, (r[1] - r[3]) * 1e3 / n, n, (r[2] - r[4]) / n, card))

    phase("22: HMC over {0} chains, {1} leapfrogs; NUTS on the dense "
          "path".format(HMC_CHAINS, HMC_LEAPFROG))
    (hr,) = run_sampler(log_prob, z0[:HMC_CHAINS].contiguous(), (4,),
                        kalman.kalman_vg, dev, "hmc",
                        num_leapfrog=HMC_LEAPFROG, num_warmup=HMC_WARMUP,
                        num_samples=HMC_SAMPLES, block_size=HMC_SAMPLES,
                        warmup_block_size=BLOCK)
    res = hr[0]
    warm_acc = float(res.warmup_accept_prob[-TERM_BUFFER:].double().mean())
    check(hr[2] == res.num_evaluations and
          bool(torch.all(torch.isfinite(res.samples))) and
          abs(warm_acc - 0.8) <= 0.15,
          "HMC: kernel launches {0} == value+gradient calls {1}, all draws "
          "finite, mean acceptance of the last {2} warmup iterations {3:.4f} "
          "within 0.15 of 0.8 (step size {4:.4f})".format(
              hr[2], res.num_evaluations, TERM_BUFFER, warm_acc,
              float(res.step_size)))
    posteriors_agree(res, chees_runs[0], "HMC (seed 4) against ChEES "
                     "(phase 4, seed 1)", stds=False)
    sampler_split(hr, kernel_ms, HMC_CHAINS, card, "HMC, seed 4")

    check(dense_lp.engine == "cuda_dense", "dense path engine {0}".format(
        dense_lp.engine))
    (dr,) = run_sampler(dense_lp, zd, (5,), dense.dense_vg, dev, "nuts",
                        max_depth=NUTS_DEPTH, num_warmup=DENSE_NUTS_WARMUP,
                        num_samples=DENSE_NUTS_SAMPLES,
                        block_size=DENSE_NUTS_SAMPLES, warmup_block_size=BLOCK)
    res = dr[0]
    div = float(res.diverging.double().mean())
    check(dr[2] == res.num_evaluations and
          bool(torch.all(torch.isfinite(res.samples))) and div < 0.01,
          "dense path NUTS over {0} chains: dense_vg launches {1} == "
          "value+gradient calls {2}, all draws finite, divergence fraction "
          "{3:.5f} < 0.01; {4:.2f} s, {5:.2f} leapfrogs per draw; on "
          "{6}".format(zd.shape[0], dr[2], res.num_evaluations, div, dr[1],
                       float(res.n_leapfrog.double().mean()), card))
    log("phases 20-22 took {0:.1f} s".format(time.time() - t_run))
    return nruns[0][2], res


def cuda_ms(fn):
    """``(fn(), ms)``: one call between two CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def ss_gp_calls(gp, t, y, yerr, ts, seed):
    """Each call of the GP API once, timed: ``({call: result}, {call:
    ms})``."""
    import torch

    results, times = {}, {}
    for name, fn in (
            ("compute", lambda: gp.compute(t, yerr)),
            ("log_likelihood", lambda: gp.log_likelihood(y)),
            ("grad_log_likelihood", lambda: gp.grad_log_likelihood(y)),
            ("apply_inverse", lambda: gp.apply_inverse(y)),
            ("predict", lambda: gp.predict(y, ts, return_var=True)),
            ("sample", lambda: gp.sample(
                size=2, generator=torch.Generator().manual_seed(seed)))):
        results[name], times[name] = cuda_ms(fn)
    return results, times


def max_rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def scan_gradient(terms, theta_k, t, r, v):
    """The plain route's value and gradient: autograd through the
    associative-scan filter (``kalman_loglike_parallel``), B chains."""
    import torch
    from george_tpu_torch.ops import state_space as sskf

    with torch.enable_grad():
        th = theta_k.detach().clone().requires_grad_(True)
        ll = sskf.kalman_loglike_parallel(terms, th, torch.diff(t), r, v)
        return ll.detach(), torch.autograd.grad(ll.sum(), th)[0]


def fit_against_scipy(gp, y, restarts, dev, what, card):
    """``optimize.minimize`` with ``restarts`` against scipy's L-BFGS-B
    over the GP's own ``nll`` / ``grad_nll`` from the best start: (result,
    launches, wall seconds)."""
    import torch
    from scipy.optimize import minimize as sp_minimize
    from george_tpu_torch import optimize
    from george_tpu_torch.ops import kalman

    kalman.kalman_vg.launches = 0
    t0 = time.time()
    res = optimize.minimize(gp, y, restarts=restarts, device=dev,
                            generator=torch.Generator().manual_seed(0),
                            set_params=False)
    wall = time.time() - t0
    launches = kalman.kalman_vg.launches
    best = int(np.argmin(np.where(np.isnan(res.restart_funs), np.inf,
                                  res.restart_funs)))
    t0 = time.time()
    ref = sp_minimize(gp.nll, res.restart_x0[best], jac=gp.grad_nll,
                      args=(y,), method="L-BFGS-B")
    sp_wall = time.time() - t0
    log("  {0}: {1} restarts, {2} batched evaluations, {3} kalman_vg "
        "launches, the winner (start {4}) {5} iterations, {6:.2f} s; "
        "restarts' objectives {7:.6f} to {8:.6f}; scipy L-BFGS-B from the "
        "same start: {9} evaluations, {10:.2f} s; on {11}".format(
            what, restarts + 1, res.evaluations, launches, best, res.nit,
            wall, float(np.nanmin(res.restart_funs)),
            float(np.nanmax(np.where(np.isfinite(res.restart_funs),
                                     res.restart_funs, np.nan))),
            ref.nfev, sp_wall, card))
    check(launches == res.evaluations and res.success,
          "{0}: kalman_vg launches {1} == evaluations {2}, converged".format(
              what, launches, res.evaluations))
    rel = abs(res.fun - ref.fun) / abs(ref.fun)
    check(rel <= 1e-6, "{0}: optimum {1:.10f} against scipy's {2:.10f} "
          "(relative {3:.2e} <= 1e-6)".format(what, res.fun, ref.fun, rel))
    return res, launches, wall


def run_state_space_gp(phase, dev, card):
    """Phase 23: the GP API's O(N) state-space solver and the fit.
    Returns the kernels line's entries for its two shapes."""
    import pickle

    import torch
    import george_tpu_torch as george
    from george_tpu_torch.ops import kalman
    from george_tpu_torch.ops import state_space as sskf
    from george_tpu_torch.samplers import build_gp_log_prob
    from george_tpu_torch.solvers import StateSpaceSolver

    t_run = time.time()
    phase("23: the GP API's state-space solver (examples/07_state_space.py, "
          "float64) at N = {0} and {1}; optimize.minimize".format(
              SS_N, SS_LONG_N))
    node = example07_kernel().spec_node()
    terms = sskf.extract_terms(node)
    ts = np.linspace(-5.0, 105.0, SS_PREDICT)

    # Against the dense solver on the card.
    t, y, yerr = example07_data(SS_CHECK_N)
    gs = george.GP(example07_kernel(), solver=StateSpaceSolver, device=dev)
    gd = george.GP(example07_kernel(), device=dev)
    rs, _ = ss_gp_calls(gs, t, y, yerr, ts, 1)
    rd, _ = ss_gp_calls(gd, t, y, yerr, ts, 1)
    for name, key, tol in (("log-likelihood", "log_likelihood", 1e-9),
                           ("gradient", "grad_log_likelihood", 1e-7),
                           ("K^-1 y", "apply_inverse", 1e-8)):
        err = max_rel(rs[key], rd[key])
        check(err <= tol, "N={0}: state-space {1} against the dense "
              "solver's, max relative {2:.2e} <= {3:g}".format(
                  SS_CHECK_N, name, err, tol))
    for i, name in enumerate(("predictive mean", "predictive variance")):
        err = max_rel(rs["predict"][i], rd["predict"][i])
        check(err <= 1e-8, "N={0}: {1} at {2} points against the dense "
              "solver's, max relative {3:.2e} <= 1e-8".format(
                  SS_CHECK_N, name, SS_PREDICT, err))
    # A pickled BasicSolver GP answers on the card without compute.
    ll0 = gd.log_likelihood(y)
    loaded = pickle.loads(pickle.dumps(gd))

    def refuse(*args, **kwargs):
        raise Failure("the unpickled GP recomputed")

    loaded.compute = refuse
    check(loaded.solver.factor.device.type == "cuda" and
          loaded.log_likelihood(y) == ll0,
          "a pickled BasicSolver GP answers on {0} without compute "
          "(log-likelihood {1:.9f})".format(loaded.device, ll0))

    entries = []
    fit_gp = None
    kalman.kalman_vg.launches = 0
    grads = 0
    for n in (SS_N, SS_LONG_N):
        t, y, yerr = example07_data(n)
        gp = george.GP(example07_kernel(), solver=StateSpaceSolver,
                       device=dev)
        res, times = ss_gp_calls(gp, t, y, yerr, ts, 2)
        grads += 1
        mu, var = res["predict"]
        draws = res["sample"]
        check(all(np.all(np.isfinite(a)) for a in (res["grad_log_likelihood"],
                                                  res["apply_inverse"], mu,
                                                  var, draws))
              and np.isfinite(res["log_likelihood"]) and draws.shape ==
              (2, n) and mu.shape == (SS_PREDICT,) and np.all(var > 0),
              "N={0}: finite results of the expected shapes, predictive "
              "variance > 0".format(n))
        log("  N={0}: compute {1:.2f} ms, log_likelihood {2:.2f}, "
            "grad_log_likelihood {3:.2f}, apply_inverse {4:.2f}, predict "
            "({5} points, return_var) {6:.2f}, sample(size=2) {7:.2f} "
            "(CUDA events, one call each; ll {8:.6f}); on {9}".format(
                n, times["compute"], times["log_likelihood"],
                times["grad_log_likelihood"], times["apply_inverse"],
                SS_PREDICT, times["predict"], times["sample"],
                res["log_likelihood"], card))
        # The kernel route's gradient against autograd through the scan.
        solver = gp.solver
        theta_k = torch.as_tensor(gp.kernel.get_parameter_vector(
            include_frozen=True), device=dev)[None]
        t_s = torch.as_tensor(solver._t, device=dev)
        r_s = torch.as_tensor(y[solver._order], device=dev)
        v_s = torch.as_tensor(solver._v, device=dev)
        _, g_scan = scan_gradient(terms, theta_k, t_s, r_s, v_s)
        g_scan = g_scan[0].cpu().numpy()
        err = max_rel(res["grad_log_likelihood"], g_scan)
        if n == SS_N:
            check(err <= 1e-8, "N={0}: the kernel route's gradient against "
                  "autograd through the associative-scan filter, max "
                  "relative {1:.2e} <= 1e-8".format(n, err))
            fit_gp, fit_y, g_err = gp, y, float(np.max(np.abs(
                res["grad_log_likelihood"] - g_scan)))
        else:
            log("  N={0}: the kernel route's gradient against the scan's, "
                "max relative {1:.2e}".format(n, err))
        # The gradient by the kernel alone, and by the plain scan.
        vg = kalman.make_kalman_vg(node, solver._t, y[solver._order],
                                   gp._yerr2[solver._order], 0, 1,
                                   (1, 2, 3, 4))
        theta_full = torch.as_tensor(gp.get_parameter_vector(
            include_frozen=True)[1:], device=dev)[None].contiguous()
        launches = kalman.kalman_vg.launches
        k_ms, k_min = median_ms(lambda: vg(theta_full), SS_TIMING_REPS)
        s_ms, s_min = median_ms(lambda: scan_gradient(terms, theta_k, t_s,
                                                      r_s, v_s), 3, warmup=1)
        kalman.kalman_vg.launches = launches
        bound, by = kalman_bound(vg.spec, 1, n, itemsize=8)
        log("  N={0}: the gradient by kalman_vg.cu at B=1 (S={1}) {2:.4f} "
            "ms (min {3:.4f}), by autograd through the associative-scan "
            "filter {4:.2f} ms (min {5:.2f}); bound {6:.4f} ms ({7}); on "
            "{8}".format(n, kalman.choose_segments(1, n, vg.spec.dim), k_ms,
                         k_min, s_ms, s_min, bound, by, card))
        if n == SS_N:
            entry = dict(ms=k_ms, plain_ms=s_ms, bound_ms=bound, bound_by=by)
    gp_launches = kalman.kalman_vg.launches
    check(gp_launches == grads, "kalman_vg launches {0} == "
          "grad_log_likelihood calls {1}".format(gp_launches, grads))
    entries.append(dict({
        "name": "kalman_vg (GP API state-space solver, B = 1, N = {0}, "
                "float64)".format(SS_N),
        "route": "cuda",
        "source": "george_tpu_torch/csrc/kalman_vg.cu",
        "replaces": "george_tpu/ops/pallas_kalman.py:66",
        "launches": gp_launches,
        "max_abs_err": g_err,
        "library_ms": None}, **entry))

    # optimize.minimize: the main path's model, then the state-space GP.
    x, y, yerr = bench_data(N)
    gp = main_gp(dev)
    gp.compute(x, yerr)
    fit_against_scipy(gp, y, FIT_RESTARTS_MAIN, dev,
                      "fit of the main path's model (N={0})".format(N), card)
    res, fit_launches, _ = fit_against_scipy(
        fit_gp, fit_y, FIT_RESTARTS_SS, dev,
        "fit of the state-space GP (N={0})".format(SS_N), card)
    # The fit's shape, B = 1 + restarts at the restarts' starts: the
    # kernel against autograd through the scan, and both timed.
    lp, _ = build_gp_log_prob(fit_gp, fit_gp._x, fit_y,
                              np.sqrt(fit_gp._yerr2), device=dev)
    vg = lp.kalman_vg
    spec = vg.spec
    base = fit_gp.get_parameter_vector(include_frozen=True)
    theta = np.tile(base, (res.restart_x0.shape[0], 1))
    theta[:, list(spec.active)] = res.restart_x0
    theta = torch.as_tensor(theta, device=dev).contiguous()
    order = fit_gp.solver._order
    t_s = torch.as_tensor(fit_gp.solver._t, device=dev)
    r_s = torch.as_tensor(fit_y[order], device=dev) - theta[:, :1]
    v_s = torch.as_tensor(fit_gp._yerr2[order], device=dev) + \
        torch.exp(theta[:, 1:2])
    _, g_k = vg(theta)
    _, g_s = scan_gradient(spec.terms, theta[:, 2:], t_s, r_s, v_s)
    g_s = g_s[:, [a - 2 for a in spec.active]]
    fit_err = float(torch.max(torch.abs(g_k - g_s)))
    check(fit_err <= 1e-8 * float(torch.max(torch.abs(g_s))),
          "the fit's kernel gradient at B={0} against the scan's, max abs "
          "{1:.3e}".format(theta.shape[0], fit_err))
    k_ms, _ = median_ms(lambda: vg(theta), SS_TIMING_REPS)
    s_ms, _ = median_ms(lambda: scan_gradient(spec.terms, theta[:, 2:], t_s,
                                              r_s, v_s), 3, warmup=1)
    bound, by = kalman_bound(spec, theta.shape[0], SS_N, itemsize=8)
    log("  the fit's shape: kalman_vg.cu at B={0}, N={1} (S={2}) {3:.4f} "
        "ms, the plain scan {4:.2f} ms, bound {5:.4f} ms ({6}); on "
        "{7}".format(theta.shape[0], SS_N, kalman.choose_segments(
            theta.shape[0], SS_N, spec.dim), k_ms, s_ms, bound, by, card))
    entries.append({
        "name": "kalman_vg (optimize.minimize, B = {0}, N = {1}, "
                "float64)".format(theta.shape[0], SS_N),
        "route": "cuda",
        "source": "george_tpu_torch/csrc/kalman_vg.cu",
        "replaces": "george_tpu/ops/pallas_kalman.py:66",
        "launches": fit_launches,
        "max_abs_err": fit_err,
        "ms": k_ms,
        "plain_ms": s_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    })
    log("phase 23 took {0:.1f} s".format(time.time() - t_run))
    return entries


# -- phases 24-27: HODLR, SMC, ADVI and a checkpoint ---------------------------

def hodlr_data(n, seed=42):
    """``benchmarks/hodlr_sampler.py``'s ``make_posterior`` data."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 100, n))
    yerr = 0.1 * np.ones(n)
    y = np.sin(x / 4.0) + yerr * rng.standard_normal(n)
    return x, y, yerr


def hodlr_gp(device, **kw):
    """Its model: ``1.0 * ExpSquaredKernel(4.0)``, fitted log white noise."""
    import george_tpu_torch as george
    from george_tpu_torch import kernels

    return george.GP(1.0 * kernels.ExpSquaredKernel(4.0),
                     white_noise=np.log(1e-3), fit_white_noise=True,
                     device=device, **kw)


def smc_posterior(device):
    """``benchmarks/smc_period.py``'s model and data (config 3): the
    ExpSine2 x ExpSquared GP, fitted log white noise, N = 120."""
    import george_tpu_torch as george
    from george_tpu_torch import kernels
    from george_tpu_torch.samplers import build_gp_log_prob

    rng = np.random.default_rng(8)
    x = np.sort(rng.uniform(0, 18, SMC_N))
    yerr = 0.15 * np.ones(SMC_N)
    y = np.sin(2 * np.pi * x / SMC_TRUE_PERIOD) \
        + yerr * rng.standard_normal(SMC_N)
    kernel = 1.0 * kernels.ExpSine2Kernel(
        gamma=3.0, log_period=np.log(2.0)) * kernels.ExpSquaredKernel(100.0)
    gp = george.GP(kernel, white_noise=np.log(1e-4), fit_white_noise=True,
                   device=device)
    lp, theta0 = build_gp_log_prob(gp, x, y, yerr, device=device)
    return gp, lp, theta0


def profiled(fn):
    """``(kernel launches, device ms)`` of one call of ``fn`` as
    torch.profiler records it (every CUDA kernel; the device time of
    kernels, copies and fills); ``(None, None)`` if it records no device
    event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None, None
    kernels = [e for e in events
               if not e.name.startswith(("Memcpy", "Memset", "memcpy",
                                         "memset"))]
    return len(kernels), sum(e.time_range.elapsed_us()
                             for e in events) / 1e3


def timed_call(fn, what, card):
    """One call of ``fn`` between CUDA events after a warm call, then one
    under the profiler: prints ms, launches and the device's share;
    returns ``(ms, launches, device ms)``."""
    fn()
    _, ms = cuda_ms(fn)
    launches, dev_ms = profiled(fn)
    if launches is None:
        log("  {0}: {1:.3f} ms (CUDA events); launches and device time not "
            "measured (the profiler recorded no device event); on {2}".format(
                what, ms, card))
    else:
        log("  {0}: {1:.3f} ms (CUDA events); {2} kernel launches, {3:.3f} "
            "ms of device time: the card busy {4:.1%} of the call, the host "
            "the rest; on {5}".format(what, ms, launches, dev_ms,
                                      min(1.0, dev_ms / ms), card))
    return ms, launches, dev_ms


def hodlr_gp_calls(gp, x, y, yerr, what, card):
    """``compute`` / ``log_likelihood`` / ``grad_log_likelihood`` /
    ``apply_inverse`` of a HODLR GP, each timed and profiled."""
    out = {}
    for name, fn in (
            ("compute", lambda: gp.compute(x, yerr)),
            ("log_likelihood", lambda: gp.log_likelihood(y)),
            ("grad_log_likelihood", lambda: gp.grad_log_likelihood(y)),
            ("apply_inverse", lambda: gp.apply_inverse(y))):
        out[name] = timed_call(fn, "{0}: {1}".format(what, name), card)
    fact = gp.solver._fact
    log("  {0}: {1} levels, leaves of {2}, rank caps {3}, ranks used {4}"
        .format(what, fact.levels, fact.leaf_size, fact.ranks,
                fact.ranks_used))
    return out


def run_hodlr_gp(phase, dev, card):
    """Phase 24: the HODLR GP API in float64."""
    import george_tpu_torch as george
    from george_tpu_torch import kernels
    from george_tpu_torch.solvers import HODLRSolver, StateSpaceSolver

    t_run = time.time()
    phase("24: the HODLR GP API (config 4, float64) at N = {0}; a Matern32 "
          "GP at N = {1}".format(HODLR_N, HODLR_LONG_N))
    x, y, yerr = hodlr_data(HODLR_N)
    gh = hodlr_gp(dev, solver=HODLRSolver, tol=1e-10)
    gd = hodlr_gp(dev)
    for g in (gh, gd):
        g.compute(x, yerr)
    ll_h, ll_d = gh.log_likelihood(y), gd.log_likelihood(y)
    g_h, g_d = gh.grad_log_likelihood(y), gd.grad_log_likelihood(y)
    check(np.allclose(ll_d, ll_h) and np.allclose(g_d, g_h),
          "N={0}, tol 1e-10: HODLR log-likelihood {1!r} against the dense "
          "BasicSolver's {2!r} (relative {3:.2e}), gradient {4} against "
          "{5} (max relative {6:.2e}): np.allclose, as tests/test_solvers.py"
          ":78-94 asserts; ranks used {7}".format(
              HODLR_N, ll_h, ll_d, abs(ll_h - ll_d) / abs(ll_d), g_h, g_d,
              max_rel(g_h, g_d), gh.solver._fact.ranks_used))
    gh = hodlr_gp(dev, solver=HODLRSolver)
    calls = hodlr_gp_calls(gh, x, y, yerr, "N={0}, tol 0.1".format(HODLR_N),
                           card)
    ll = gh.log_likelihood(y)
    check(np.isfinite(ll) and np.all(np.isfinite(gh.grad_log_likelihood(y)))
          and gh.solver._fact.levels == 6 and gh.solver._fact.leaf_size == 157,
          "N={0}, tol 0.1: 6 levels, leaves of 157, finite log-likelihood "
          "{1!r} (the dense one {2!r}, relative {3:.2e})".format(
              HODLR_N, ll, ll_d, abs(ll - ll_d) / abs(ll_d)))

    t, y5, yerr5 = example07_data(HODLR_LONG_N)
    gs = george.GP(1.0 * kernels.Matern32Kernel(2.0), solver=StateSpaceSolver,
                   device=dev)
    gs.compute(t, yerr5)
    ll_s = gs.log_likelihood(y5)
    gh5 = george.GP(1.0 * kernels.Matern32Kernel(2.0), solver=HODLRSolver,
                    tol=1e-10, device=dev)
    calls5 = hodlr_gp_calls(gh5, t, y5, yerr5, "Matern32 N={0}, tol "
                            "1e-10".format(HODLR_LONG_N), card)
    ll_h5 = gh5.log_likelihood(y5)
    fact = gh5.solver._fact
    check(np.allclose(ll_s, ll_h5) and fact.levels == 9 and
          fact.leaf_size == 196,
          "Matern32 N={0}, tol 1e-10: 9 levels, leaves of 196, HODLR "
          "log-likelihood {1!r} against the state-space solver's {2!r} "
          "(relative {3:.2e}): np.allclose".format(
              HODLR_LONG_N, ll_h5, ll_s, abs(ll_h5 - ll_s) / abs(ll_s)))
    log("phase 24 took {0:.1f} s".format(time.time() - t_run))
    return calls, calls5


class _NoKernel(object):
    """A launch counter for a path with no hand kernel (HODLR, the plain
    dense route): ``run_sampler`` resets and reads it."""

    launches = 0


def batched_vg(lp):
    """The batched value+gradient that ``run_mcmc`` takes for ``lp``."""
    from george_tpu_torch.samplers import mcmc

    return getattr(lp, "batched_value_and_grad", None) \
        or mcmc._autograd_vg(lp)


def vg_call(lp, z, what, card):
    """One batched value+gradient of ``lp`` at ``z``, timed and
    profiled."""
    vg = batched_vg(lp)
    return timed_call(lambda: vg(z), what, card)


def run_hodlr_sampler(phase, dev, card):
    """Phase 25: the HODLR sampler route against the dense one."""
    import torch
    from george_tpu_torch import optimize
    from george_tpu_torch.samplers import build_gp_log_prob
    from george_tpu_torch.samplers import split_rhat

    t_run = time.time()
    phase("25: the HODLR sampler route (config 4's match leg, N = {0}, "
          "NUTS over {1} chains) against the dense route ({2} "
          "chains)".format(HODLR_SAMPLER_N, HODLR_CHAINS,
                           HODLR_DENSE_CHAINS))
    x, y, yerr = hodlr_data(HODLR_SAMPLER_N)
    gp = hodlr_gp(dev)
    prior = bench_prior(gp, dev, torch.float64)
    lp_match, _ = build_gp_log_prob(
        gp, x, y, yerr, log_prior=prior, method="hodlr",
        method_options=dict(MATCH_OPTS), device=dev)
    fit = optimize.minimize(gp, y, x=x, yerr=yerr, log_prior=prior,
                            method="dense", device=dev)
    theta_map = torch.as_tensor(fit.x, device=dev)
    lp_h, _ = build_gp_log_prob(
        gp, x, y, yerr, log_prior=prior, method="hodlr",
        method_options=dict(HODLR_OPTS), device=dev)
    lp_d, _ = build_gp_log_prob(gp, x, y, yerr, log_prior=prior,
                                method="dense", device=dev)
    check(lp_h.engine == "hodlr" and lp_d.engine == "torch_dense_autograd"
          and fit.success,
          "engines {0} and {1}; the MAP {2} ({3} evaluations); the replay's "
          "ranks {4}".format(lp_h.engine, lp_d.engine,
                             np.round(fit.x, 4), fit.evaluations,
                             lp_h.hodlr_ranks))
    z0 = theta_map + 0.1 * torch.as_tensor(
        np.random.default_rng(5).standard_normal(
            (HODLR_CHAINS, len(theta_map))), device=dev)
    zd = z0[:HODLR_DENSE_CHAINS].contiguous()
    ld, gd = batched_vg(lp_d)(z0)
    for what, lp in (("the match leg's density (tol {0}, pinned at the "
                      "generating parameters)".format(MATCH_OPTS["tol"]),
                      lp_match),
                     ("the sampled density (tol {0}, pinned at the "
                      "MAP)".format(HODLR_OPTS["tol"]), lp_h)):
        lh, gh = batched_vg(lp)(z0)
        log("  {0} against the dense one around the MAP: max |delta ll| "
            "{1:.3e} nats, max |delta grad| {2:.3e}".format(
                what, float((lh - ld).abs().max()),
                float((gh - gd).abs().max())))
    hodlr_ms = vg_call(lp_h, z0, "HODLR value+gradient, N={0}, B={1}".format(
        HODLR_SAMPLER_N, HODLR_CHAINS), card)
    dense_ms = vg_call(lp_d, zd, "dense value+gradient, N={0}, B={1}".format(
        HODLR_SAMPLER_N, HODLR_DENSE_CHAINS), card)
    runs = {}
    for name, lp, z in (("HODLR", lp_h, z0), ("dense", lp_d, zd)):
        (r,) = run_sampler(lp, z, (6,), _NoKernel, dev, "nuts",
                           max_depth=NUTS_DEPTH, num_warmup=HODLR_WARMUP,
                           num_samples=HODLR_SAMPLES,
                           block_size=HODLR_SAMPLES, warmup_block_size=BLOCK)
        res, seconds = r[0], r[1]
        div = float(res.diverging.double().mean())
        rhat = split_rhat(res.samples.double()).cpu().numpy()
        check(bool(torch.all(torch.isfinite(res.samples))) and div < 0.01,
              "{0} NUTS: all draws finite, divergence fraction {1:.5f} < "
              "0.01; split R-hat {2}; {3} chains, {4} value+gradient calls "
              "in {5:.2f} s ({6:.2f} ms a call), {7:.2f} leapfrogs per draw; "
              "on {8}".format(
                  name, div, np.round(rhat, 4), z.shape[0],
                  res.num_evaluations, seconds,
                  seconds * 1e3 / res.num_evaluations,
                  float(res.n_leapfrog.double().mean()), card))
        runs[name] = res
    posteriors_agree(runs["HODLR"], runs["dense"],
                     "HODLR against dense NUTS, N={0}".format(
                         HODLR_SAMPLER_N))
    draws = runs["dense"].samples.reshape(-1, len(theta_map))
    pick = torch.as_tensor(np.random.default_rng(7).choice(
        draws.shape[0], HODLR_CHAINS, replace=False), device=dev)
    zs = draws[pick].double().contiguous()
    (lh, gh), (ld, gd) = batched_vg(lp_h)(zs), batched_vg(lp_d)(zs)
    log("  at {0} of the dense run's draws: HODLR against dense, max |delta "
        "ll| {1:.3e} nats (median {2:.3e}), max |delta grad| {3:.3e}".format(
            HODLR_CHAINS, float((lh - ld).abs().max()),
            float((lh - ld).abs().median()), float((gh - gd).abs().max())))

    x, y, yerr = hodlr_data(HODLR_N)
    gp = hodlr_gp(dev)
    gp.set_parameter_vector(fit.x)
    lp_b, theta_b = build_gp_log_prob(
        gp, x, y, yerr, log_prior=prior, method="hodlr",
        method_options=dict(HODLR_OPTS), device=dev)
    zb = theta_b + 0.1 * torch.as_tensor(
        np.random.default_rng(6).standard_normal(
            (HODLR_BIG_CHAINS, len(theta_b))), device=dev)
    big_ms = vg_call(lp_b, zb, "HODLR value+gradient, N={0}, B={1} (ranks "
                     "{2})".format(HODLR_N, HODLR_BIG_CHAINS,
                                   lp_b.hodlr_ranks), card)
    lb, gb = lp_b.batched_value_and_grad(zb)
    check(bool(torch.all(torch.isfinite(lb)) and torch.all(
        torch.isfinite(gb))), "N={0}: finite values and gradients over {1} "
          "chains".format(HODLR_N, HODLR_BIG_CHAINS))
    log("phase 25 took {0:.1f} s".format(time.time() - t_run))
    return hodlr_ms, dense_ms, big_ms


def run_smc_config3(phase, dev, card, smc):
    """Phase 26: SMC over config 3's posterior, every target evaluation a
    launch of ``dense_vg.cu``.  Returns ``{mutation: (launches,
    particle-mutations a second, seconds, result)}``."""
    import torch
    from george_tpu_torch.ops import dense
    from george_tpu_torch.samplers import run_smc

    t_run = time.time()
    phase("26: SMC at config 3 (benchmarks/smc_period.py: N = {0}, {1} "
          "particles, {2} mutations a stage)".format(
              SMC_N, SMC_PARTICLES, SMC_MUTATIONS))
    gp, lp, theta0 = smc
    check(lp.engine == "cuda_dense", "engine {0}".format(lp.engine))
    log_init, scale = smc_log_init(theta0)
    i_period = next(i for i, nm in enumerate(gp.get_parameter_names())
                    if nm.endswith("log_period"))
    out = {}
    for mutation, seed in (("hmc", 0), ("rw", 1)):
        p0, gen = smc_start(theta0, scale, seed, dev)
        dense.dense_vg.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        res = run_smc(lp, log_init, p0, gen, num_mutations=SMC_MUTATIONS,
                      mutation=mutation, device=dev)
        torch.cuda.synchronize()
        elapsed = time.time() - t0
        launches = dense.dense_vg.launches
        periods = torch.exp(res.particles[:, i_period].double())
        median = float(torch.median(periods))
        rate = res.num_stages * SMC_MUTATIONS * SMC_PARTICLES / elapsed
        check(launches == res.num_evaluations and bool(torch.all(
            torch.isfinite(res.particles))) and
              abs(median - SMC_TRUE_PERIOD) < 0.15,
              "SMC ({0}): dense_vg launches {1} == target evaluations {2}; "
              "period median {3:.4f} within 0.15 of the true {4}; {5} "
              "stages, acceptance {6:.3f}, log Z {7:.3f}; {8:.2f} s, {9:.1f} "
              "particle-mutations/s; on {10}".format(
                  mutation, launches, res.num_evaluations, median,
                  SMC_TRUE_PERIOD, res.num_stages, float(res.acceptance),
                  float(res.log_evidence), elapsed, rate, card))
        out[mutation] = (launches, rate, elapsed, res)
    log("phase 26 took {0:.1f} s".format(time.time() - t_run))
    return out


def run_advi_checkpoint(phase, dev, card, lp64, theta64, chees):
    """Phase 27: ADVI on the main path over ``kalman_vg.cu`` against phase
    4's ChEES posterior, and a NUTS state saved and restored on the card.
    Returns the Kalman kernel's launches in the ADVI run."""
    import torch
    from george_tpu_torch import checkpoint
    from george_tpu_torch.ops import kalman
    from george_tpu_torch.samplers import hmc, nuts, run_advi

    t_run = time.time()
    phase("27: ADVI on the main path ({0} steps, {1} draws a step, "
          "float64) and a checkpoint".format(ADVI_STEPS, ADVI_MC))
    kalman.kalman_vg.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    res = run_advi(lp64, theta64, 3, num_steps=ADVI_STEPS, num_mc=ADVI_MC,
                   device=dev)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = kalman.kalman_vg.launches
    draws = chees.samples.double().reshape(-1, chees.samples.shape[-1])
    m, sd = draws.mean(0), draws.std(0)
    gap = (res.mean - m).abs()
    first, last = float(res.elbo[:100].mean()), float(res.elbo[-100:].mean())
    check(launches == ADVI_STEPS and bool(torch.all(gap <= sd)) and
          last > first,
          "ADVI: kalman_vg launches {0} == steps {1}; fitted mean {2} "
          "within one posterior sd {3} of phase 4's ChEES mean {4} (gaps "
          "{5}); ELBO's mean over the last 100 steps {6:.3f} > the first "
          "100's {7:.3f}; {8:.2f} s, {9:.3f} ms a step; on {10}".format(
              launches, ADVI_STEPS, np.round(res.mean.cpu().numpy(), 4),
              np.round(sd.cpu().numpy(), 4), np.round(m.cpu().numpy(), 4),
              np.round(gap.cpu().numpy(), 4), last, first, seconds,
              seconds * 1e3 / ADVI_STEPS, card))

    vg = lp64.batched_value_and_grad
    gen = torch.Generator(device=dev).manual_seed(12)
    z = theta64 + 0.1 * torch.randn((256, len(theta64)), generator=gen,
                                    device=dev, dtype=theta64.dtype)
    inv_mass = torch.ones(len(theta64), device=dev, dtype=theta64.dtype)
    step = torch.tensor(0.2, device=dev, dtype=theta64.dtype)
    state, _ = nuts.nuts_step(gen, hmc.new_state(vg, z), vg, step, inv_mass,
                              max_depth=NUTS_DEPTH)
    saved = checkpoint.sampler_state(state, gen, step, inv_mass)
    folder = os.path.join(HERE, "build")
    os.makedirs(folder, exist_ok=True)
    path = checkpoint.save_checkpoint(
        os.path.join(folder, "chip_smoke_checkpoint"), saved)
    back = checkpoint.restore_checkpoint(path, target=saved, device=dev)
    same = all(torch.equal(a, b) and a.dtype == b.dtype and
               a.device == b.device
               for a, b in zip(back["chain_states"], state))
    resumed = torch.Generator(device=dev)
    resumed.set_state(back["key"].cpu())
    a, _ = nuts.nuts_step(gen, state, vg, step, inv_mass,
                          max_depth=NUTS_DEPTH)
    b, _ = nuts.nuts_step(resumed, back["chain_states"], vg,
                          back["step_size"], back["inv_mass"],
                          max_depth=NUTS_DEPTH)
    check(same and all(torch.equal(u, v) for u, v in zip(a, b)),
          "a NUTS state of {0} chains saved to {1} and restored on {2} bit "
          "for bit; the next transition from it and its generator the same "
          "bits as from the original".format(z.shape[0],
                                             os.path.relpath(path, HERE),
                                             dev))
    os.remove(path)
    log("phase 27 took {0:.1f} s".format(time.time() - t_run))
    return launches, seconds


# -- slice 12: the multi-rank layer (phases 28-30) ---------------------------

class _CollectiveClock(object):
    """Host seconds and calls inside the collectives' transfers (every one
    goes through ``gather_stack`` or ``all_reduce_sum``): under gloo the
    staging copies (which wait for the card's queued work) and the
    exchange, under NCCL the enqueue only.  A context manager: the
    transfers are wrapped inside it."""

    def __enter__(self):
        from george_tpu_torch.parallel import collectives

        self.seconds, self.calls = 0.0, 0
        self.saved = {name: getattr(collectives, name)
                      for name in ("gather_stack", "all_reduce_sum")}
        for name, fn in self.saved.items():
            setattr(collectives, name, self._timed(fn))
        return self

    def __exit__(self, *exc):
        from george_tpu_torch.parallel import collectives

        for name, fn in self.saved.items():
            setattr(collectives, name, fn)

    def _timed(self, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1
        return timed

    def read(self):
        return self.seconds, self.calls


def timed_once(fn):
    """``(fn(), seconds)``: one call timed by the port's
    ``profiling.timeit`` (the card synchronized on its tensor outputs)."""
    from george_tpu_torch import profiling

    out = []

    def call():
        out.append(fn())
        return out[-1]

    seconds = profiling.timeit(call, repeats=1, warmup=0)
    return out[0], seconds


def posterior_stats(res):
    """Means, Monte Carlo standard errors, max split R-hat, distinct
    chains and the draws' acceptance, divergences and leapfrogs of a run
    (on its device)."""
    import torch
    from george_tpu_torch.samplers import effective_sample_size, split_rhat

    s = res.samples.double()
    flat = s.reshape(-1, s.shape[-1])
    ess = effective_sample_size(s)
    return dict(
        shape=tuple(s.shape), finite=bool(torch.all(torch.isfinite(s))),
        mean=flat.mean(0).cpu().numpy(),
        se=(flat.std(0) / torch.sqrt(ess)).cpu().numpy(),
        rhat=float(split_rhat(s).max()), min_ess=float(ess.min()),
        distinct=int(torch.unique(res.samples.reshape(s.shape[0], -1),
                                  dim=0).shape[0]),
        accept=float(res.accept_prob.double().mean()),
        divergent=float(res.diverging.double().mean()),
        leapfrogs=float(res.n_leapfrog.double().mean()))


def _sharded_mcmc(dev, clock, log_prob, z0, mesh, counter, seed, **opts):
    """One ``run_mcmc_sharded`` run on this rank: its launches (the count
    set to 0 just before, read just after), evaluations, pooled step size
    and mass, wall (``profiling.timeit``) and collective seconds; rank 0
    adds the gathered posterior's statistics."""
    import torch
    from george_tpu_torch.parallel import run_mcmc_sharded

    chain = mesh.axis("chains")
    z0 = torch.as_tensor(z0, device=dev)
    counter.launches = 0
    c0 = clock.read()
    torch.cuda.synchronize()
    res, seconds = timed_once(lambda: run_mcmc_sharded(
        log_prob, None, z0, seed, mesh, **opts))
    out = dict(engine=log_prob.engine, chains=z0.shape[0] // chain.size,
               launches=counter.launches, evaluations=res.num_evaluations,
               step_size=res.step_size.cpu().numpy(),
               inv_mass=res.inv_mass.cpu().numpy(), seconds=seconds,
               collective_s=clock.read()[0] - c0[0],
               collectives=clock.read()[1] - c0[1])
    if chain.index == 0:
        out["stats"] = posterior_stats(res)
    return out


def _job_chees(dev, clock, mesh, z0):
    """Phase 28: the main path's ChEES leg, chains over the ranks."""
    import torch
    from george_tpu_torch.ops import kalman
    from george_tpu_torch.samplers import build_gp_log_prob

    x, y, yerr = bench_data(N)
    gp = main_gp(dev)
    lp, _ = build_gp_log_prob(gp, x, y, yerr,
                              log_prior=bench_prior(gp, dev, torch.float32),
                              device=dev, dtype=torch.float32)
    return _sharded_mcmc(dev, clock, lp, z0, mesh, kalman.kalman_vg, 1,
                         algorithm="chees",
                         num_warmup=WARMUP, num_samples=SAMPLES,
                         num_leapfrog=MAX_LEAPFROG, block_size=BLOCK,
                         warmup_block_size=BLOCK)


def _job_dense_nuts(dev, clock, mesh, zd):
    """Phase 28: config #5 under NUTS (phase 22's run), chains over the
    ranks."""
    import torch
    from george_tpu_torch.ops import dense
    from george_tpu_torch.samplers import build_gp_log_prob

    xd, yd, yerrd = config5_data()
    gp5 = config5_gp(dev)
    lp, _ = build_gp_log_prob(gp5, xd, yd, yerrd, method="dense",
                              log_prior=bench_prior(gp5, dev, torch.float32),
                              device=dev, dtype=torch.float32)
    return _sharded_mcmc(dev, clock, lp, zd, mesh, dense.dense_vg, 5,
                         algorithm="nuts",
                         max_depth=NUTS_DEPTH, num_warmup=DENSE_NUTS_WARMUP,
                         num_samples=DENSE_NUTS_SAMPLES,
                         block_size=DENSE_NUTS_SAMPLES,
                         warmup_block_size=BLOCK)


def _device_ms(prof):
    """Device milliseconds of the CUDA events a profiler recorded (None if
    it recorded none)."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    return sum(e.time_range.elapsed_us() for e in events) / 1e3


def _job_data(dev, clock, mesh, trace_dir):
    """Phase 29: the data-sharded BASELINE model in float64 on each route,
    every stripe a launch of the covariance kernel: the value and the
    gradient, each call's launches, times (``profiling.timeit``) and this
    rank's peak memory; a ``profiling.trace`` of one value+gradient on the
    replicated route."""
    import torch
    from george_tpu_torch import config, profiling
    from george_tpu_torch.parallel import make_sharded_gp_log_prob_factory
    from george_tpu_torch.parallel.mesh import shard

    old = config.pallas_covariance
    config.pallas_covariance = "always"
    axis = mesh.axis("data")
    out = {}
    try:
        for label, n, worlds in SHARD_CASES:
            if axis.size not in worlds:
                continue
            x, y, yerr = chol16k_data(n)
            gp = baseline_gp(dev, torch.float64)
            factory, data = make_sharded_gp_log_prob_factory(gp, x, y, yerr,
                                                             mesh=mesh)
            lp = factory(*(shard(torch.as_tensor(d, device=dev), axis)
                           for d in data))
            theta = torch.as_tensor(gp.get_parameter_vector(), device=dev,
                                    dtype=torch.float64)

            def value():
                with torch.no_grad():
                    return lp(theta)

            def value_and_grad():
                th = theta.clone().requires_grad_(True)
                v = lp(th)
                return v.detach(), torch.autograd.grad(v, th)[0]

            # One call each, timed with its launches counted.
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            c0 = clock.read()
            reset_cov_counts()
            v, value_s = timed_once(value)
            value_launches = cov_counts()
            reset_cov_counts()
            (v2, g), grad_s = timed_once(value_and_grad)
            grad_launches = cov_counts()
            c1 = clock.read()
            row = dict(engine=lp.engine, n_total=data[0].shape[0],
                       value=float(v), value2=float(v2),
                       grad=g.cpu().numpy(), value_launches=value_launches,
                       grad_launches=grad_launches, value_s=value_s,
                       grad_s=grad_s, collective_s=c1[0] - c0[0],
                       collectives=c1[1] - c0[1],
                       peak_bytes=torch.cuda.max_memory_allocated(dev))
            if label == "replicated":
                with profiling.trace(trace_dir) as prof:
                    with profiling.annotate("phase 29 value+gradient"):
                        value_and_grad()
                        torch.cuda.synchronize()
                row["trace_device_ms"] = _device_ms(prof)
            out[label] = row
            del lp, factory
    finally:
        config.pallas_covariance = old
    return out


def _job_mesh_hmc(dev, clock, mesh):
    """Phase 29: chains x data HMC on a 2 x 2 mesh (tests/test_parallel.py's
    test_chains_by_data_hmc at N = MESH_HMC_N)."""
    import torch
    import george_tpu_torch as george
    from george_tpu_torch import config, kernels
    from george_tpu_torch.parallel import (
        make_sharded_gp_log_prob_factory, run_mcmc_sharded)

    x, y, yerr = bench_data(MESH_HMC_N)
    gp = george.GP(1.0 * kernels.Matern32Kernel(1.0), device=dev)
    factory, data = make_sharded_gp_log_prob_factory(gp, x, y, yerr,
                                                     mesh=mesh)
    theta0 = gp.get_parameter_vector()
    z0 = theta0 + 0.05 * np.random.default_rng(3).standard_normal(
        (MESH_HMC_CHAINS, len(theta0)))
    old = config.pallas_covariance
    config.pallas_covariance = "always"
    try:
        reset_cov_counts()
        c0 = clock.read()
        res, seconds = timed_once(lambda: run_mcmc_sharded(
            factory, data, z0, 3, mesh, data_axis="data", algorithm="hmc",
            num_leapfrog=8, step_size=0.05, num_warmup=20, num_samples=20))
    finally:
        config.pallas_covariance = old
    return dict(engine=factory(*data).engine,
                finite=bool(torch.all(torch.isfinite(res.samples))),
                accept=float(res.accept_prob.double().mean()),
                shape=tuple(res.samples.shape),
                evaluations=res.num_evaluations, launches=cov_counts(),
                seconds=seconds, collective_s=clock.read()[0] - c0[0])


def smc_log_init(theta0):
    """Phase 26's initial density around theta0 and its scales."""
    import torch

    dim = len(theta0)
    scale = torch.as_tensor([1.0, 1.0, 0.8, 1.0, 1.0][:dim],
                            device=theta0.device, dtype=theta0.dtype)
    const = float(-torch.sum(torch.log(scale)) - 0.5 * dim * np.log(
        2 * np.pi))

    def log_init(z):
        d = (z - theta0) / scale
        return -0.5 * torch.sum(d * d, dim=-1) + const

    return log_init, scale


def smc_start(theta0, scale, seed, dev):
    """Phase 26's starting cloud and the generator that drew it."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    p0 = theta0 + scale * torch.randn((SMC_PARTICLES, len(theta0)),
                                      generator=gen, device=dev,
                                      dtype=theta0.dtype)
    return p0, gen


def _job_smc(dev, clock, mesh):
    """Phase 30: phase 26's HMC run, the particles' evaluations over the
    ranks."""
    import torch
    from george_tpu_torch.ops import dense
    from george_tpu_torch.parallel import run_smc_sharded

    gp, lp, theta0 = smc_posterior(dev)
    log_init, scale = smc_log_init(theta0)
    p0, gen = smc_start(theta0, scale, 0, dev)
    dense.dense_vg.launches = 0
    c0 = clock.read()
    torch.cuda.synchronize()
    res, seconds = timed_once(lambda: run_smc_sharded(
        lp, log_init, p0, gen, mesh, num_mutations=SMC_MUTATIONS,
        mutation="hmc"))
    return dict(engine=lp.engine, launches=dense.dense_vg.launches,
                evaluations=res.num_evaluations, stages=res.num_stages,
                particles=res.particles.cpu().numpy(),
                log_evidence=float(res.log_evidence),
                lambdas=res.lambdas.cpu().numpy(), seconds=seconds,
                collective_s=clock.read()[0] - c0[0])


# Each job and the axis of the mesh it runs on ("2x2": chains x data).
RANK_JOBS = {"chees": (_job_chees, "chains"),
             "dense_nuts": (_job_dense_nuts, "chains"),
             "data": (_job_data, "data"), "mesh_hmc": (_job_mesh_hmc, "2x2"),
             "smc": (_job_smc, "particles")}


def job_mesh(P, axis, dev):
    """The mesh of a job on the first P ranks of the process group (None
    on the others).  Every rank calls it: group creation is collective."""
    import torch.distributed as dist
    from george_tpu_torch.parallel import chain_data_mesh, chain_mesh
    from george_tpu_torch.parallel.mesh import Axis, Mesh

    if axis == "2x2":
        return chain_data_mesh(2, 2, device=dev)
    if P == dist.get_world_size():
        return chain_mesh(axis=axis, device=dev)
    group = dist.new_group(list(range(P)))
    rank = dist.get_rank()
    return Mesh([Axis(axis, P, rank, group)], dev) if rank < P else None


def _rank_main(rank, world, backend, root, jobs, t_start):
    """One rank: the process group over ``root``'s rendezvous file, then
    each job ``(name, P, args)`` on the first P ranks, on the card (every
    rank on cuda:0); its results and timeline (seconds from ``t_start``)
    saved."""
    t_entry = time.time() - t_start
    sys.path.insert(0, HERE)
    import datetime
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(root, "rendezvous"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        out = {"timeline": [("entered", t_entry),
                            ("group ready", time.time() - t_start)]}
        with _CollectiveClock() as clock:
            for name, P, args in jobs:
                fn, axis = RANK_JOBS[name]
                mesh = job_mesh(P, axis, dev)
                # Every job starts on all ranks together (the ranks idle
                # in a P = 2 job would wait inside the next one's first
                # collective, and count it).
                dist.barrier()
                if mesh is None:
                    continue
                t0 = time.time()
                key = "{0} P={1}".format(name, P)
                out[key] = fn(dev, clock, mesh, *args)
                out[key + " wall"] = time.time() - t0
        out["timeline"].append(("jobs done", time.time() - t_start))
        torch.save(out, os.path.join(root, "rank{0}.pt".format(rank)))
    finally:
        dist.destroy_process_group()


def spawn_ranks(world, backend, jobs):
    """``jobs`` ([(name, P, args)]) on ``world`` ranks sharing the card (a
    world of one in this process), each job on the first P; each rank's
    results.  The kernels are built already (phase 1): the ranks load
    them.  A failure in any rank fails the phase."""
    import shutil
    import tempfile
    import torch
    import torch.multiprocessing as mp

    root = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    torch.cuda.empty_cache()
    t0 = time.time()
    try:
        if world == 1:
            _rank_main(0, 1, backend, root, jobs, t0)
        else:
            mp.spawn(_rank_main, args=(world, backend, root, jobs, t0),
                     nprocs=world, join=True)
        out = [torch.load(os.path.join(root, "rank{0}.pt".format(r)),
                          weights_only=False) for r in range(world)]
    except Exception as exc:
        raise Failure("{0} ranks over {1}: {2}".format(world, backend, exc))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    walls = []
    for name, P, _ in jobs:
        key = "{0} P={1}".format(name, P)
        walls.append("{0} {1:.1f} s".format(key, max(
            r[key + " wall"] for r in out[:P])))
    log("  {0} rank(s) over {1}: {2:.1f} s; the slowest rank's wall by job: "
        "{3}; rank 0's timeline {4}".format(
            world, backend, time.time() - t0, ", ".join(walls), ", ".join(
                "{0} at {1:.1f} s".format(*e) for e in out[0]["timeline"])))
    return out


def check_chain_sharded(tag, ranks, ref, chains, gate_rhat, card):
    """Phase 28's gates on one sharded run: launches == value+gradient
    calls at the rank's chain count on every rank, the pooled step size
    and mass the same bits on every rank, the draws finite, every chain
    distinct, (for ChEES) split R-hat < 1.01, and the means within 5
    combined MC standard errors of the single-process run ``ref``."""
    world = len(ranks)
    for r, o in enumerate(ranks):
        check(o["launches"] == o["evaluations"] and
              o["chains"] == chains // world and o["engine"].startswith(
                  "cuda_"),
              "{0}, rank {1}: {2} launches == value+gradient calls {3} at B "
              "= {4} (engine {5})".format(tag, r, o["launches"],
                                          o["evaluations"], o["chains"],
                                          o["engine"]))
    steps = {o["step_size"].tobytes() for o in ranks}
    masses = {o["inv_mass"].tobytes() for o in ranks}
    check(len(steps) == 1 and len(masses) == 1,
          "{0}: pooled step size {1!r} and mass {2} the same bits on all {3} "
          "ranks".format(tag, float(ranks[0]["step_size"]),
                         ranks[0]["inv_mass"], world))
    st = ranks[0]["stats"]
    check(st["finite"] and st["distinct"] == chains and
          st["shape"][0] == chains,
          "{0}: draws {1} finite, {2} distinct chains of {3}".format(
              tag, st["shape"], st["distinct"], chains))
    if gate_rhat:
        check(st["rhat"] < 1.01, "{0}: max split R-hat {1:.5f} < 1.01".format(
            tag, st["rhat"]))
    gap = np.abs(st["mean"] - ref["mean"])
    bound = 5.0 * np.sqrt(st["se"] ** 2 + ref["se"] ** 2)
    check(bool(np.all(gap <= bound)),
          "{0}: means {1} against the single-process run's {2}: gaps {3} "
          "within 5 combined MC standard errors {4}".format(
              tag, np.round(st["mean"], 4), np.round(ref["mean"], 4),
              np.round(gap, 5), np.round(bound, 5)))
    wall, coll = max((o["seconds"], o["collective_s"]) for o in ranks)
    share = coll / wall
    log("  {0}: {1:.2f} s (slowest rank), {2:.2f} s of it in collectives "
        "({3:.1%}, {4} calls); max split R-hat {5:.5f}, min ESS {6:.1f}, "
        "acceptance {7:.4f}, divergences {8:.5f}, {9:.2f} leapfrogs a draw, "
        "step size {10:.6f}; on {11}".format(
            tag, wall, coll, share, ranks[0]["collectives"], st["rhat"],
            st["min_ess"], st["accept"], st["divergent"], st["leapfrogs"],
            float(ranks[0]["step_size"]), card))


def check_data_sharded(P, ranks, refs, card):
    """Phase 29's gates at P ranks: the engine each case takes, the value
    within rtol 1e-9 and the gradient within rtol 1e-7 of the
    single-process float64 GP, one forward covariance launch a value and
    one forward and one VJP a gradient on every rank."""
    expect = {"dist_chol": ("dist_chol", 16384),
              "replicated": ("sharded_replicated_chol", 4096),
              "dist_chol padded": ("dist_chol", 16384)}
    for label, n, worlds in SHARD_CASES:
        if P not in worlds:
            continue
        ll_ref, g_ref = refs[n]
        errs = []
        for r, rank in enumerate(ranks):
            o = rank[label]
            check((o["engine"], o["n_total"]) == expect[label],
                  "P={0} {1} N={2}, rank {3}: engine {4}, N padded to "
                  "{5}".format(P, label, n, r, o["engine"], o["n_total"]))
            check(o["value_launches"] == (1, 0) and
                  o["grad_launches"] == (1, 1),
                  "P={0} {1} N={2}, rank {3}: covariance launches (forward, "
                  "VJP) {4} a value, {5} a gradient".format(
                      P, label, n, r, o["value_launches"],
                      o["grad_launches"]))
            v_err = max(abs(o["value"] - ll_ref), abs(o["value2"] - ll_ref))
            g_err = np.abs(o["grad"] - g_ref)
            ok = v_err <= 1e-9 * abs(ll_ref) and bool(np.all(
                g_err <= 1e-7 * np.abs(g_ref) + 1e-7 * np.abs(g_ref).max()))
            check(ok, "P={0} {1} N={2}, rank {3}: value {4!r} against the "
                  "single-process GP's {5!r} (rtol 1e-9), gradient {6} "
                  "against {7} (rtol 1e-7)".format(
                      P, label, n, r, o["value"], ll_ref, o["grad"], g_ref))
            errs.append((v_err / abs(ll_ref),
                         float((g_err / np.abs(g_ref).max()).max())))
        slow = max(range(P), key=lambda r: ranks[r][label]["grad_s"])
        o = ranks[slow][label]
        log("  P={0} {1} N={2}: value {3:.3f} s, value+gradient {4:.3f} s "
            "(profiling.timeit, slowest rank), {5:.3f} s of them in "
            "collectives ({6:.1%}, {7} calls); peak memory a rank {8} GiB; "
            "max rel. error value {9:.2e}, gradient {10:.2e}{11}; on "
            "{12}".format(
                P, label, n, o["value_s"], o["grad_s"], o["collective_s"],
                o["collective_s"] / (o["value_s"] + o["grad_s"]),
                o["collectives"],
                ", ".join("{0:.2f}".format(rk[label]["peak_bytes"]
                                           / 2 ** 30) for rk in ranks),
                max(e[0] for e in errs), max(e[1] for e in errs),
                "" if o.get("trace_device_ms") is None else
                "; one traced value+gradient {0:.2f} ms on the card".format(
                    o["trace_device_ms"]), card))


def run_sharded(phase, dev, card, z0, chees_ref, zd, dense_nuts_ref,
                smc_ref):
    """Phases 28-30 over P ranks sharing the card.  Returns the slice's
    launches per rank for the JSON line."""
    import torch
    from george_tpu_torch import config

    t_run = time.time()
    # The single-process float64 references of phase 29 (the GP API, the
    # plain covariance route), computed before the ranks start.
    refs = {}
    old = config.pallas_covariance
    config.pallas_covariance = "never"
    try:
        for _, n, _ in SHARD_CASES:
            x, y, yerr = chol16k_data(n)
            gp = baseline_gp(dev, torch.float64)
            gp.compute(x, yerr)
            refs[n] = (float(gp.log_likelihood(y)),
                       np.asarray(gp.grad_log_likelihood(y)))
            del gp
    finally:
        config.pallas_covariance = old
    torch.cuda.empty_cache()
    trace_dir = os.path.join(HERE, "build", "phase29_trace")
    z0_np = z0.cpu().numpy()
    zd_np = zd.cpu().numpy()

    phase("28-30: the multi-rank layer, {0} and {1} ranks sharing the card "
          "over gloo (the first 2 of 4 ranks for P = 2), 1 over "
          "NCCL".format(*SHARD_WORLDS))
    ranks = spawn_ranks(4, "gloo", [
        ("chees", 2, (z0_np,)), ("dense_nuts", 2, (zd_np,)),
        ("data", 2, (trace_dir,)), ("smc", 2, ()),
        ("dense_nuts", 4, (zd_np,)), ("data", 4, (trace_dir,)),
        ("mesh_hmc", 4, ())])
    one = spawn_ranks(1, "nccl", [("chees", 1, (z0_np,))])

    def results(job, P):
        key = "{0} P={1}".format(job, P)
        return [r[key] for r in (one if P == 1 else ranks)[:P]]

    phase("28: chain-sharded sampling")
    ref = posterior_stats(chees_ref)
    for tag, P in (("ChEES, main path, P=2 (gloo)", 2),
                   ("ChEES, main path, P=1 (NCCL)", 1)):
        check_chain_sharded(tag, results("chees", P), ref, CHAINS, True,
                            card)
    ref = posterior_stats(dense_nuts_ref)
    for P in SHARD_WORLDS:
        check_chain_sharded("NUTS, config #5, P={0} (gloo)".format(P),
                            results("dense_nuts", P), ref, DENSE_CHAINS,
                            False, card)

    phase("29: data-sharded likelihoods (float64)")
    for P in SHARD_WORLDS:
        check_data_sharded(P, results("data", P), refs, card)
    hmc = results("mesh_hmc", 4)
    for r, o in enumerate(hmc):
        check(o["engine"] == "sharded_replicated_chol" and o["finite"] and
              o["accept"] > 0.2 and o["launches"] == (o["evaluations"],
                                                      o["evaluations"]),
              "chains x data HMC on a 2 x 2 mesh, N={0}, rank {1}: engine "
              "{2}, draws {3} finite, mean acceptance {4:.4f} > 0.2, "
              "covariance launches (forward, VJP) {5} == value+gradient "
              "calls {6}; {7:.2f} s, {8:.2f} s in collectives; on {9}".format(
                  MESH_HMC_N, r, o["engine"], o["shape"], o["accept"],
                  o["launches"], o["evaluations"], o["seconds"],
                  o["collective_s"], card))

    phase("30: sharded SMC at config 3, P=2")
    ref_launches, _, ref_s, ref_res = smc_ref
    p_ref = ref_res.particles.cpu().numpy()
    smc = results("smc", 2)
    for r, o in enumerate(smc):
        same = (o["stages"] == ref_res.num_stages and np.allclose(
            o["lambdas"], ref_res.lambdas.cpu().numpy(), rtol=1e-10,
            atol=0.0) and np.allclose(o["particles"], p_ref, rtol=1e-10,
                                      atol=1e-10 * np.abs(p_ref).max())
            and abs(o["log_evidence"] - float(ref_res.log_evidence))
            <= 1e-10 * abs(float(ref_res.log_evidence)))
        check(same, "SMC P=2, rank {0}: {1} stages, temperatures, particles "
              "and log Z {2!r} equal phase 26's ({3} stages, log Z {4!r}) at "
              "rtol 1e-10".format(r, o["stages"], o["log_evidence"],
                                  ref_res.num_stages,
                                  float(ref_res.log_evidence)))
        check(o["engine"] == "cuda_dense" and
              o["launches"] == o["evaluations"] == ref_launches,
              "SMC P=2, rank {0}: dense_vg launches {1} == evaluations {2} "
              "at B = {3} (phase 26: {4} at B = {5})".format(
                  r, o["launches"], o["evaluations"], SMC_PARTICLES // 2,
                  ref_launches, SMC_PARTICLES))
    wall, coll = max((o["seconds"], o["collective_s"]) for o in smc)
    log("  SMC P=2: {0:.2f} s (phase 26 on one process: {1:.2f} s), {2:.2f} "
        "s of it in collectives ({3:.1%}); on {4}".format(
            wall, ref_s, coll, coll / wall, card))
    log("phases 28-30 took {0:.1f} s".format(time.time() - t_run))
    def launches(job, P):
        return [o["launches"] for o in results(job, P)]

    def cov(P, label, i):
        return [o[label]["value_launches"][i] + o[label]["grad_launches"][i]
                for o in results("data", P)]

    cases = [(P, label) for P in SHARD_WORLDS
             for label, _, worlds in SHARD_CASES if P in worlds]
    return {
        "kalman_vg": {"phase 28 ChEES P=2": launches("chees", 2),
                      "phase 28 ChEES P=1 NCCL": launches("chees", 1)},
        "dense_vg": {"phase 28 NUTS P=2": launches("dense_nuts", 2),
                     "phase 28 NUTS P=4": launches("dense_nuts", 4),
                     "phase 30 SMC P=2": launches("smc", 2)},
        "stationary_cov_fwd": {"phase 29 P={0} {1}".format(P, label):
                               cov(P, label, 0) for P, label in cases},
        "stationary_cov_bwd": {"phase 29 P={0} {1}".format(P, label):
                               cov(P, label, 1) for P, label in cases},
    }


# -- phase 31: the examples ---------------------------------------------------


def load_example(number):
    """``examples_torch/<number>_*.py`` as a module."""
    import glob

    path, = glob.glob(os.path.join(HERE, "examples_torch",
                                   number + "_*.py"))
    return load_file(path, "example_" + number)


def _counters():
    from george_tpu_torch.ops import batched_mm, cov, dense, dense_mxu, kalman

    return {"kalman_vg": kalman.kalman_vg, "dense_vg": dense.dense_vg,
            "stationary_cov_fwd": cov.stationary_cov_fwd,
            "stationary_cov_bwd": cov.stationary_cov_bwd,
            "dense_spine": dense_mxu.spine,
            "batched_mmT": batched_mm.batched_mmT}


def example_instances(dev):
    """The instantiation phase 31 launches that no earlier phase builds:
    example 01's dense tree (``ExpSquaredKernel`` under a constant, mean
    and white noise frozen) in float64.  Examples 02, 06 and 09 run the
    float64 instances of the main path, config 3 and config #5."""
    import torch
    import george_tpu_torch as george
    from george_tpu_torch import kernels
    from george_tpu_torch.samplers import build_gp_log_prob

    x = np.linspace(0.0, 10.0, 15)
    gp = george.GP(1.0 * kernels.ExpSquaredKernel(0.5), device=dev)
    lp, _ = build_gp_log_prob(gp, x, np.sin(x), 0.2, device=dev)
    return [("example 01 (phase 31)", torch.float64,
             lp.dense_vg.spec.instance(torch.float64))]


def check_against_cpu(number, mod, out, keys, sizes):
    """A GP-API example's printed numbers on the card against its run with
    device="cpu" (the float64 plain versions) at the same sizes."""
    ref = mod.main(device="cpu", **sizes)
    errs = {k: max_rel(out[k], ref[k]) for k in keys}
    check(all(e <= EXAMPLE_RTOL for e in errs.values()),
          "example {0}: the card's numbers equal the CPU's within rtol {1} "
          "(relative errors {2})".format(
              number, EXAMPLE_RTOL,
              ", ".join("{0} {1:.2e}".format(k, e) for k, e in errs.items())))


def check_example_hook(mod, dev):
    """Example 08's densities (the mean model through ``torch_value``) on
    the card against the CPU's, float64: values within EXAMPLE_HOOK_RTOL
    relative, each point's gradient within it of its largest component."""
    import torch
    from george_tpu_torch.samplers import build_gp_log_prob

    t, y, yerr = mod.generate_data(mod.TRUTH, 50, device=dev)
    card_models = mod.make_models(y, device=dev)
    cpu_models = mod.make_models(y, device="cpu")
    rng = np.random.default_rng(31)
    for label, g_card, g_cpu, methods in (
            ("white-noise model", card_models[0], cpu_models[0],
             ("dense",)),
            ("correlated-noise model", card_models[1], cpu_models[1],
             ("dense", "auto"))):
        for method in methods:
            vals = []
            for g, device in ((g_card, dev), (g_cpu, "cpu")):
                lp, theta0 = build_gp_log_prob(g, t, y, yerr, method=method,
                                               device=device)
                if not vals:
                    pts = theta0.cpu().numpy()[None] + 0.1 * np.vstack([
                        np.zeros((1, len(theta0))), rng.standard_normal(
                            (EXAMPLE_HOOK_POINTS, len(theta0)))])
                th = torch.as_tensor(pts, device=theta0.device) \
                    .requires_grad_(True)
                v = lp(th)
                grad, = torch.autograd.grad(v.sum(), th)
                vals.append((lp.engine, v.detach().cpu().numpy(),
                             grad.cpu().numpy()))
            (engine, v_c, g_c), (_, v_h, g_h) = vals
            e_v = float(np.max(np.abs(v_c - v_h) / np.abs(v_h)))
            e_g = float(np.max(np.abs(g_c - g_h).max(axis=1)
                               / np.abs(g_h).max(axis=1)))
            check(bool(np.all(np.isfinite(v_c))) and
                  e_v <= EXAMPLE_HOOK_RTOL and e_g <= EXAMPLE_HOOK_RTOL,
                  "example 08 {0}, method {1!r} (engine {2}): value and "
                  "gradient through torch_value on the card against the "
                  "CPU's at {3} points, relative errors {4:.2e} and {5:.2e} "
                  "(<= {6})".format(label, method, engine, len(pts), e_v,
                                    e_g, EXAMPLE_HOOK_RTOL))


def run_examples(phase, dev, card):
    """Phase 31: examples_torch/ 01-06, 08 and 09 through their main() on
    the card, each timed with its kernel launches, under the gates of the
    module docstring.  Returns each kernel's launches over the phase."""
    import torch

    t_run = time.time()
    phase("31: the examples (examples_torch/ 01-06, 08 and 09; 07 is "
          "phase 23's)")
    counters = _counters()
    total = {}
    for number, sizes in EXAMPLE_SIZES.items():
        mod = load_example(number)
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        out = mod.main(device=dev, **sizes)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        counts = {k: c.launches for k, c in counters.items() if c.launches}
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        log("  example {0} at {1}: {2:.2f} s, kernel launches {3}; on "
            "{4}".format(number, sizes or "its own sizes", seconds,
                         counts or "none", card))
        if number == "01":
            check(counts == {"dense_vg": out["evaluations"]},
                  "example 01: optimize.minimize's {0} batched evaluations, "
                  "one dense_vg.cu launch each at B = 1, and no other "
                  "launch".format(out["evaluations"]))
            check_against_cpu(number, mod, out,
                              ("ll", "band", "scipy_fun", "fun"), sizes)
        elif number == "02":
            calls = out["nuts"].num_evaluations + out["chees"].num_evaluations
            check(out["engine"] == "cuda_kalman" and
                  counts == {"kalman_vg": calls},
                  "example 02: engine {0}, kalman_vg.cu launches {1} == "
                  "value+gradient calls {2} (NUTS {3}, ChEES {4})".format(
                      out["engine"], counts.get("kalman_vg", 0), calls,
                      out["nuts"].num_evaluations,
                      out["chees"].num_evaluations))
            posteriors_agree(out["nuts"], out["chees"],
                             "example 02 NUTS against ChEES", stds=False)
        elif number in ("03", "04", "05"):
            keys = {"03": ("ll", "rms_trend", "rms_seasonal"),
                    "04": ("grad_mu", "fd", "t", "mu"),
                    "05": ("K", "gradient", "x1_gradient")}[number]
            check_against_cpu(number, mod, out, keys, sizes)
            if number == "04":
                check(abs(out["grad_mu"] - out["fd"]) < 1e-5,
                      "example 04: analytic d mu/dt {0!r} against finite "
                      "difference {1!r} within 1e-5".format(out["grad_mu"],
                                                            out["fd"]))
        elif number == "06":
            res = out["result"]
            check(out["engine"] == "cuda_dense" and
                  counts == {"dense_vg": res.num_evaluations} and
                  abs(out["median"] - out["true_period"]) < 0.15,
                  "example 06: engine {0}, dense_vg.cu launches {1} == "
                  "target evaluations {2}, period median {3:.4f} within "
                  "0.15 of {4}".format(out["engine"],
                                       counts.get("dense_vg", 0),
                                       res.num_evaluations, out["median"],
                                       out["true_period"]))
        elif number == "08":
            (m_w, s_w), (m_g, s_g) = out["location_white"], out["location_gp"]
            truth = mod.TRUTH["location"]
            rhat_loc = out["location_gp_rhat"]
            check(not counts and rhat_loc < 1.1 and
                  bool(torch.all(torch.isfinite(out["corr_result"].samples)))
                  and bool(torch.all(torch.isfinite(
                      out["white_result"].samples))) and
                  abs(m_g - truth) < 2 * s_g and
                  abs(m_w - truth) > abs(m_g - truth),
                  "example 08: engines {0}, no hand kernel; location: the "
                  "GP model's {1:+.4f} +/- {2:.4f} (split R-hat {6:.4f} < "
                  "1.1) within 2 sd of the truth {3:+.3f}, the white-noise "
                  "model's {4:+.4f} +/- {5:.4f} further from it; {7} and "
                  "{8} value+gradient calls".format(
                      out["engines"], m_g, s_g, truth, m_w, s_w, rhat_loc,
                      out["white_result"].num_evaluations,
                      out["corr_result"].num_evaluations))
            check_example_hook(mod, dev)
        elif number == "09":
            res = out["result"]
            rhat = float(torch.max(out["stats"]["rhat"]))
            check(out["engine"] == "cuda_dense" and
                  counts == {"dense_vg": res.num_evaluations} and
                  rhat < 1.1 and
                  bool(torch.all(torch.isfinite(res.samples))),
                  "example 09: engine {0}, dense_vg.cu launches {1} == "
                  "value+gradient calls {2}, max split R-hat {3:.4f} < "
                  "1.1".format(out["engine"], counts.get("dense_vg", 0),
                               res.num_evaluations, rhat))
    log("phase 31 took {0:.1f} s; launches {1}; on {2}".format(
        time.time() - t_run, total, card))
    return total


def run(dev, card):
    import torch
    import george_tpu_torch as george
    from george_tpu_torch import _build, kernels
    from george_tpu_torch.ops import dense, kalman
    from george_tpu_torch.samplers import build_gp_log_prob

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

    xd, yd, yerrd = config5_data()
    gp5 = config5_gp(dev)
    dense_lp, dense_theta0 = build_gp_log_prob(
        gp5, xd, yd, yerrd, method="dense",
        log_prior=bench_prior(gp5, dev, torch.float32), device=dev,
        dtype=torch.float32)
    check(dense_lp.engine == "cuda_dense",
          "dense path engine is {0}".format(dense_lp.engine))
    dense_main = dense_lp.dense_vg
    check(dense_main.spec.d_full == 5 and
          dense_main.spec.active == (0, 1, 2, 3, 4),
          "dense path layout: D_full={0}, active={1}".format(
              dense_main.spec.d_full, dense_main.spec.active))
    dzoo = {}
    for name, (make, kw, freeze, n) in dense_zoo().items():
        g = george.GP(make(), device=dev, **kw)
        if freeze:
            g.freeze_parameter(freeze)
        xz3, yz3, yerrz3 = config5_data(n, seed=11)
        lp, _ = build_gp_log_prob(g, xz3, yz3, yerrz3, method="dense",
                                  device=dev)
        check(lp.engine == "cuda_dense", "dense zoo {0} engine is {1}".format(
            name, lp.engine))
        dzoo[name] = (g, lp)

    def instances(labelled):
        return [(label, dt, vg.spec.instance(dt)) for label, vg in labelled
                for dt in (torch.float32, torch.float64)]

    def report(built, seconds):
        log("  built {0} instantiations in {1:.2f} s (parallel nvcc)".format(
            len(built), seconds))
        for label, dt, inst in built:
            # A library may hold several kernels: each is labelled by its
            # place in ptxas's order.
            lines, k = [], 0
            for line in _build.ptxas_report(inst):
                if "entry function" in line:
                    k += 1
                    lines.append("kernel {0} ({1}):".format(
                        k, entry_name(line)))
                elif "registers" in line or "spill" in line:
                    lines.append(line)
            sec = _build.build_seconds(inst)
            log("  ptxas {0} {1}{2}: {3}".format(
                label, str(dt).split(".")[-1],
                "" if sec is None else " (nvcc {0:.1f} s)".format(sec),
                " | ".join(lines)))

    # The Kalman zoo's instantiations build in the background while the
    # paths run (its 6-state case spills and takes minutes); phase 10 waits
    # for them.
    built = instances([("kalman main path", main_vg),
                       ("dense path", dense_main)] +
                      [("dense zoo " + name, lp.dense_vg)
                       for name, (_, lp) in dzoo.items()])
    smc = smc_posterior(dev)
    check(smc[1].engine == "cuda_dense", "SMC path engine is {0}".format(
        smc[1].engine))
    built += instances([("SMC config 3 (phase 26)", smc[1].dense_vg)])
    built += cov_instances() + mxu_instances() + sharded_instances()
    built += [("state-space GP (phase 23)", torch.float64,
               example07_spec().instance(torch.float64))]
    built += example_instances(dev)
    keys = {inst.key() for _, _, inst in built}
    zoo_built = [b for b in instances([("kalman zoo " + name, v)
                                       for name, (_, v) in zoo_vgs.items()])
                 if b[2].key() not in keys]
    zoo_build = {}

    def build_zoo():
        t = time.time()
        try:
            _build.build_many([inst for _, _, inst in zoo_built])
        except Exception as exc:  # reported by phase 10
            zoo_build["error"] = exc
        zoo_build["seconds"] = time.time() - t

    zoo_thread = threading.Thread(target=build_zoo)
    zoo_thread.start()
    t0 = time.time()
    _build.build_many([inst for _, _, inst in built])
    report(built, time.time() - t0)
    for line in mxu_smem_lines():
        log(line)
    for what, B, n in (("main path", CHAINS, N),
                       ("long series", LONG_CHAINS, LONG_N),
                       ("long series check", LONG_CHECK_CHAINS, LONG_CHECK_N),
                       ("zoo (main spec)", ZOO_CHAINS, 200)):
        S = kalman.choose_segments(B, n, spec.dim)
        log("  Kalman launcher at B={0}, N={1} ({2}): S={3}, {4}".format(
            B, n, what, S, launch_shape(S)))

    # -- phase 2: Kalman kernel against the plain version --------------------
    phase("2: Kalman kernel against the plain version")
    theta_main = torch.as_tensor(
        full_thetas(gp, spec.active, 7, CHAINS, 0.1), device=dev)
    errs = compare(main_vg, theta_main,
                   "main path B={0} N={1}".format(CHAINS, N),
                   segments=(None,) + FORCED_SEGMENTS)
    for n in RAGGED_N:
        xr, yr, yerrr = bench_data(n, seed=n)
        lp_r, _ = build_gp_log_prob(gp, xr, yr, yerrr, device=dev)
        th_r = torch.as_tensor(full_thetas(gp, spec.active, 31,
                                           RAGGED_CHAINS, 0.1), device=dev)
        compare(lp_r.kalman_vg, th_r, "short series B={0} N={1}".format(
            RAGGED_CHAINS, n), segments=(None,) + FORCED_SEGMENTS)

    # -- phase 3: exactness across methods ------------------------------------
    phase("3: exactness across methods (float64)")
    prior64 = bench_prior(gp, dev, torch.float64)
    lp64, theta64 = build_gp_log_prob(gp, x, y, yerr, log_prior=prior64,
                                      device=dev, dtype=torch.float64)
    gp.compute(x, yerr)
    dense_ll = float(gp.log_likelihood(y) + gp.log_prior()
                     + float(prior64(theta64)))
    ss = float(lp64(theta64))
    check(abs(ss - dense_ll) <= 1e-10 * abs(dense_ll),
          "state-space log_prob {0!r} == dense {1!r} (rtol 1e-10)".format(
              ss, dense_ll))
    lp_k, g_k = lp64.batched_value_and_grad(theta64[None])
    g_dense = gp.grad_log_likelihood(y)
    check(abs(float(lp_k[0]) - dense_ll) <= 1e-10 * abs(dense_ll) and
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
    runs = run_chees(log_prob, z0, (1, 2), kalman.kalman_vg, dev,
                     num_warmup=WARMUP, num_samples=SAMPLES,
                     num_leapfrog=MAX_LEAPFROG, block_size=BLOCK,
                     warmup_block_size=BLOCK)
    for seed, (res, seconds, launches) in zip((1, 2), runs):
        chees_gates(res, seconds, launches, WARMUP, REF_DRAWS_ACCEPT,
                    REF_STEP_SIZE, REF_LEAPFROGS_PER_DRAW, seed, card)
    means_agree([r[0] for r in runs])
    main_launches = runs[0][2]

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

    # -- phase 5: Kalman timing -------------------------------------------------
    phase("5: Kalman timing at B={0}, N={1} (CUDA events)".format(CHAINS, N))
    th32 = theta_main.float().contiguous()
    ms, ms_min = kalman_sweep(main_vg, th32, MAIN_SWEEP, 50, card,
                              "kernel float32")
    plain_ms, plain_min = median_ms(
        lambda: kalman.kalman_vg_torch(spec, th32, *main_vg.series(th32)),
        reps=5, warmup=1)
    bound_ms, bound_by = kalman_bound(spec, CHAINS, N)
    log("  plain version float32: median {0:.2f} ms (min {1:.2f}) over 5 "
        "calls".format(plain_ms, plain_min))
    log("  bound {0:.4f} ms, set by {1} ({2} primal operations per step x "
        "(1 + {3} tangents), FP32 peak {4:.0f} TFLOP/s, HBM {5} TB/s); "
        "kernel at {6:.1%} of the bound; library call: none; on {7}".format(
            bound_ms, bound_by, step_ops(spec.terms), len(spec.active),
            PEAK_FP32 / 1e12, PEAK_BYTES / 1e12, bound_ms / ms, card))
    kernels_line = [{
        "name": "kalman_vg",
        "route": "cuda",
        "source": "george_tpu_torch/csrc/kalman_vg.cu",
        "replaces": "george_tpu/ops/pallas_kalman.py:66",
        "launches": main_launches,
        "max_abs_err": errs[torch.float32],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]

    # -- phase 6: dense kernel against the plain version ------------------------
    phase("6: dense kernel against the plain version")
    theta_dense = torch.as_tensor(full_thetas(
        gp5, dense_main.spec.active, 13, DENSE_CHAINS, 0.2), device=dev)
    dense_err = compare_dense(dense_main, theta_dense, "dense path B={0} "
                              "N={1}".format(DENSE_CHAINS, DENSE_N))
    for n in DENSE_SIZES:
        xe, ye, yerre = config5_data(n)
        lp_e, _ = build_gp_log_prob(gp5, xe, ye, yerre, method="dense",
                                    device=dev)
        vg_e = lp_e.dense_vg
        check(lp_e.engine == "cuda_dense" and vg_e.spec == dense_main.spec,
              "N={0}: engine {1}, the dense path's instantiation".format(
                  n, lp_e.engine))
        ws64, ws32 = (dense._workspace_words(dense._library(vg_e.spec, dt),
                                             n, vg_e.spec.d_full)
                      for dt in (torch.float64, torch.float32))
        check(ws32 == 0 and (ws64 == 0) == (n <= DENSE_SMEM_LAST64),
              "N={0}: tiles in shared memory in float32, in {1} in "
              "float64".format(n, "device memory ({0} words a chain)".format(
                  ws64) if ws64 else "shared memory"))
        th = torch.as_tensor(full_thetas(gp5, vg_e.spec.active, 17, 512,
                                         0.2), device=dev)
        compare_dense(vg_e, th, "config #5 B=512 N={0}".format(n))
    for name, (g, lp) in dzoo.items():
        vg = lp.dense_vg
        th = full_thetas(g, vg.spec.active, 19, ZOO_CHAINS, 0.15)
        # Two rejected points: a log amplitude of 1000 overflows, so the
        # factorization fails (inf / inf), and a metric parameter out of
        # bounds (where the metric is bounded).
        n_scalar = vg.spec.n_mean + vg.spec.n_wn
        th[0, n_scalar] = 1000.0
        th[1, -1] = 1e3
        th = torch.as_tensor(th, device=dev)
        compare_dense(vg, th, "dense zoo {0} B={1} N={2} active={3}".format(
            name, ZOO_CHAINS, len(vg.data(th)[1]), vg.spec.active))
        if n_scalar not in vg.spec.active:
            continue
        unfrozen = torch.as_tensor(np.flatnonzero(g.unfrozen_mask),
                                   device=dev)
        lp_b, g_b = lp.batched_value_and_grad(th[:3, unfrozen].float())
        torch.cuda.synchronize()
        bounded = g.get_parameter_bounds(include_frozen=True)[-1][1] \
            is not None
        check(bool(torch.isneginf(lp_b[0])) and
              bool(torch.all(g_b[0] == 0)) and
              bool(torch.isneginf(lp_b[1])) == bounded and
              bool(torch.all(g_b[1] == 0)) == bounded and
              bool(torch.isfinite(lp_b[2])),
              "dense zoo {0}: the failed factorization reads -inf with a "
              "zero gradient{1}".format(
                  name, ", and so does the out-of-bounds point" if bounded
                  else ""))

    # -- phase 7: the dense path -------------------------------------------------
    phase("7: the dense path, ChEES over {0} chains".format(DENSE_CHAINS))
    zd = dense_theta0 + 0.1 * torch.as_tensor(
        np.random.default_rng(0).standard_normal(
            (DENSE_CHAINS, len(dense_theta0))), device=dev,
        dtype=dense_theta0.dtype)
    druns = run_chees(dense_lp, zd, (1, 2), dense.dense_vg, dev,
                      num_warmup=WARMUP, num_samples=DENSE_SAMPLES,
                      num_leapfrog=DENSE_MAX_LEAPFROG, block_size=BLOCK,
                      warmup_block_size=BLOCK)
    for seed, (res, seconds, launches) in zip((1, 2), druns):
        chees_gates(res, seconds, launches, WARMUP, REF_DENSE_ACCEPT,
                    REF_DENSE_STEP_SIZE, REF_DENSE_LEAPFROGS_PER_DRAW, seed,
                    card)
    means_agree([r[0] for r in druns])
    dense_launches = druns[0][2]
    td32 = theta_dense.float().contiguous()
    d_run_ms, _ = median_ms(lambda: dense_main(td32), reps=10)
    for seed, (res, seconds, launches) in zip((1, 2), druns):
        log("  seed {0}: wall {1:.2f} s for {2} launches; launches x kernel "
            "time ({3:.4f} ms, B={4}) = {5:.2f} s ({6:.1%} of the wall); the "
            "rest, {7:.2f} s, is host-driven leapfrog and adaptation, {8:.3f} "
            "ms a call; on {9}".format(
                seed, seconds, launches, d_run_ms, DENSE_CHAINS,
                launches * d_run_ms / 1e3,
                launches * d_run_ms / 1e3 / seconds,
                seconds - launches * d_run_ms / 1e3,
                (seconds * 1e3 - launches * d_run_ms) / launches, card))

    # -- phase 8: the long series ---------------------------------------------
    phase("8: the long series, N={0}".format(LONG_N))
    xl, yl, yerrl = stream_data()
    gpl = main_gp(dev)
    long_lp, long_theta0 = build_gp_log_prob(
        gpl, xl, yl, yerrl, log_prior=bench_prior(gpl, dev, torch.float32),
        device=dev, dtype=torch.float32)
    check(long_lp.engine == "cuda_kalman" and
          long_lp.kalman_vg.spec == spec,
          "N={0}: engine {1}, the main path's instantiation".format(
              LONG_N, long_lp.engine))
    long_vg = long_lp.kalman_vg
    th_long = torch.as_tensor(full_thetas(gpl, spec.active, 23, LONG_CHAINS,
                                          0.1), device=dev)
    l64, g64 = long_vg(th_long)
    l32, g32 = long_vg(th_long.float())
    torch.cuda.synchronize()
    l32, g32 = l32.double(), g32.double()
    long_err = max(float((l32 - l64).abs().max()),
                   float((g32 - g64).abs().max()))
    check(bool(torch.all(torch.isfinite(l32))) and
          within_reference_tolerance(l32, g32, l64, g64),
          "N={0} B={1} S={5}: float32 kernel against float64 kernel, max "
          "|ll err| {2:.3e}, max |grad err| {3:.3e} (|ll| up to {4:.4g})"
          .format(LONG_N, LONG_CHAINS, float((l32 - l64).abs().max()),
              float((g32 - g64).abs().max()), float(l64.abs().max()),
              launcher_segments(long_vg, th_long)))
    xc, yc, yerrc = stream_data(LONG_CHECK_N, seed=1)
    lp_c, _ = build_gp_log_prob(gpl, xc, yc, yerrc, device=dev)
    vg_c = lp_c.kalman_vg
    th_c = torch.as_tensor(full_thetas(gpl, spec.active, 29,
                                       LONG_CHECK_CHAINS, 0.1), device=dev)
    lk, gk = vg_c(th_c)
    torch.cuda.synchronize()
    t0 = time.time()
    lr, gr = kalman.kalman_vg_torch(vg_c.spec, th_c, *vg_c.series(th_c))
    torch.cuda.synchronize()
    long_plain_ms = 1e3 * (time.time() - t0)
    check(bool(torch.all((lk - lr).abs() <= 1e-9 * lr.abs())) and
          bool(torch.all((gk - gr).abs() <= 1e-9 * gr.abs() + 1e-9)),
          "N={0} B={1} S={5}: float64 kernel against the plain version "
          "({2:.1f} s), max |ll err| {3:.3e}, max |grad err| {4:.3e}".format(
              LONG_CHECK_N, LONG_CHECK_CHAINS, long_plain_ms / 1e3,
              float((lk - lr).abs().max()), float((gk - gr).abs().max()),
              launcher_segments(vg_c, th_c)))
    zl = long_theta0 + 0.1 * torch.as_tensor(
        np.random.default_rng(0).standard_normal(
            (LONG_CHAINS, len(long_theta0))), device=dev,
        dtype=long_theta0.dtype)
    (lres, lsec, long_launches), = run_chees(
        long_lp, zl, (1,), kalman.kalman_vg, dev, num_warmup=20,
        num_samples=20, num_leapfrog=16, block_size=10, warmup_block_size=10)
    check(long_launches == lres.num_evaluations and long_launches >= 40 and
          bool(torch.all(torch.isfinite(lres.samples))),
          "N={0}: a 20 + 20 iteration ChEES run over {1} chains, {2} kernel "
          "launches == value+gradient calls {3}, draws finite, in {4:.2f} s"
          .format(LONG_N, LONG_CHAINS, long_launches, lres.num_evaluations,
                  lsec))

    # -- phase 9: dense and long-series timing ------------------------------------
    phase("9: timing of the dense kernel and the long series (CUDA events)")
    (_, _, d_ms, d_plain, d_bound, d_by), *_ = time_dense(dev, card)
    # The plain version's time is its one call of phase 8 (float64, B=2,
    # N=32769): a call at B=1024 and N=100,000 would take minutes and tens
    # of GB of autograd tape.
    tl32 = th_long.float().contiguous()
    l_ms, l_min = kalman_sweep(long_vg, tl32, LONG_SWEEP, 10, card,
                               "Kalman kernel float32 B={0} N={1}".format(
                                   LONG_CHAINS, LONG_N))
    l_plain = long_plain_ms
    l_bound, l_by = kalman_bound(spec, LONG_CHAINS, LONG_N)
    log("  Kalman kernel float32 B={0} N={1}: median {2:.4f} ms (min "
        "{3:.4f}) over 10 launches; bound {4:.4f} ms set by {5}; kernel at "
        "{6:.1%} of the bound; plain version {7:.1f} ms (one float64 call at "
        "B={8}, N={9}, phase 8); library call: none; on {10}".format(
            LONG_CHAINS, LONG_N, l_ms, l_min, l_bound, l_by, l_bound / l_ms,
            l_plain, LONG_CHECK_CHAINS, LONG_CHECK_N, card))

    # -- phase 10: the Kalman zoo ---------------------------------------------
    phase("10: the Kalman zoo against the plain version")
    zoo_thread.join()
    if "error" in zoo_build:
        raise Failure("Kalman zoo build: {0}".format(zoo_build["error"]))
    report(zoo_built, zoo_build["seconds"])
    for name, (g, vg) in zoo_vgs.items():
        th = torch.as_tensor(full_thetas(g, vg.spec.active, 11, ZOO_CHAINS,
                                         0.2), device=dev)
        compare(vg, th, "zoo {0} B={1} N=200 active={2}".format(
            name, ZOO_CHAINS, vg.spec.active),
            segments=(None,) + FORCED_SEGMENTS)

    # -- phase 11: covariance kernels against their plain versions ---------
    phase("11: covariance kernels against their plain versions")
    cov_err_f, cov_err_b = check_cov_kernels(dev)

    # -- phase 12: the GP API at full width -----------------------------------
    phase("12: the GP API, BASELINE model at N={0}, config #5's kernel at "
          "N={1}".format(GP_N, GP5_N))
    gp_path = run_gp_api(dev, card)

    # -- phase 13: the vmapped dense sampler density ----------------------------
    phase("13: the dense sampler density at N={0}, B={1}, float32".format(
        SAMPLER_N, SAMPLER_CHAINS))
    run_sampler_density(dev)

    # -- phase 14: covariance timing ---------------------------------------------
    phase("14: timing of the covariance kernels and of GP.compute (CUDA "
          "events)")
    cov_lines = time_cov(dev, card, gp_path, cov_err_f, cov_err_b)

    # -- phases 15-16: the blocked dense engine ---------------------------------
    phase("15-16: the spine and the batched product against their plain "
          "versions; the blocked dense engine at N = {0} to {1}".format(
              MXU_SHAPES[0][0], MXU_SHAPES[-1][0]))
    spine_err, mm_err, engine = run_mxu_engine(dev)

    # -- phase 17: posterior fidelity ------------------------------------------
    phase("17: posterior fidelity at N={0}, ChEES over {1} chains, blocked "
          "against fused engine".format(FID_N, FID_CHAINS))
    spine_launches = run_fidelity(dev, card)

    # -- phase 18: the batched-product benchmark ------------------------------
    phase("18: tools/batched_mm.py at B={0}, N={1}".format(MM_B, MM_N))
    mm_lines, mm_launches = run_batched_mm(card)

    # -- phase 19: timing of the slice's kernels --------------------------------
    phase("19: timing of the spine, the blocked engine and the batched "
          "product (CUDA events)")
    (sp_ms, sp_plain, sp_lib, sp_bound, sp_by), \
        (mm_ms, mm_plain, mm_lib, mm_b, mm_by) = time_mxu(dev, card, engine,
                                                        mm_lines)

    # -- phases 20-22: NUTS and HMC -----------------------------------------
    nuts_launches, dense_nuts = run_nuts(phase, log_prob, z0,
                                         [r[0] for r in runs], dense_lp, zd,
                                         ms, dev, card)
    kernels_line[0]["nuts_launches"] = nuts_launches

    # -- phase 23: the GP API's state-space solver and the fit ---------------
    ss_lines = run_state_space_gp(phase, dev, card)

    # -- phases 24-27: HODLR, SMC, ADVI and a checkpoint ----------------------
    run_hodlr_gp(phase, dev, card)
    run_hodlr_sampler(phase, dev, card)
    smc_runs = run_smc_config3(phase, dev, card, smc)
    advi_launches, _ = run_advi_checkpoint(phase, dev, card, lp64, theta64,
                                           runs[0][0])
    kernels_line[0]["advi_launches"] = advi_launches

    # -- phases 28-30: the multi-rank layer ------------------------------------
    sharded = run_sharded(phase, dev, card, z0, runs[0][0], zd, dense_nuts,
                          smc_runs["hmc"])

    # -- phase 31: the examples ------------------------------------------------
    examples = run_examples(phase, dev, card)
    kernels_line[0]["examples_launches"] = examples.get("kalman_vg", 0)

    kernels_line += [{
        "name": "kalman_vg (streaming, N > 32768)",
        "route": "cuda",
        "source": "george_tpu_torch/csrc/kalman_vg.cu",
        "replaces": "george_tpu/ops/pallas_kalman.py:162",
        "launches": long_launches,
        "max_abs_err": long_err,
        "ms": l_ms,
        "plain_ms": l_plain,
        "bound_ms": l_bound,
        "bound_by": l_by,
        "library_ms": None,
    }, {
        "name": "dense_vg",
        "route": "cuda",
        "source": "george_tpu_torch/csrc/dense_vg.cu",
        "replaces": "george_tpu/ops/pallas_dense.py:420",
        "launches": dense_launches,
        "smc_launches": smc_runs["hmc"][0],
        "examples_launches": examples.get("dense_vg", 0),
        "max_abs_err": dense_err,
        "ms": d_ms,
        "plain_ms": d_plain,
        "bound_ms": d_bound,
        "bound_by": d_by,
        "library_ms": None,
    }] + cov_lines + [{
        "name": "dense_spine",
        "route": "cuda",
        "source": "george_tpu_torch/csrc/dense_spine.cu",
        "replaces": "george_tpu/ops/dense_mxu.py:96",
        "launches": spine_launches,
        "max_abs_err": spine_err,
        "ms": sp_ms,
        "plain_ms": sp_plain,
        "bound_ms": sp_bound,
        "bound_by": sp_by,
        "library_ms": sp_lib,
    }, {
        "name": "batched_mmT",
        "route": "cuda",
        "source": "george_tpu_torch/csrc/batched_mmT.cu",
        "replaces": "benchmarks/pallas_batched_mm.py:75, "
                    "benchmarks/pallas_batched_mm.py:124",
        "launches": mm_launches,
        "max_abs_err": mm_err,
        "ms": mm_ms,
        "plain_ms": mm_plain,
        "bound_ms": mm_b,
        "bound_by": mm_by,
        "library_ms": mm_lib,
    }] + ss_lines
    for entry in kernels_line:
        if entry["name"] in sharded:
            entry["sharded_launches_per_rank"] = sharded[entry["name"]]
    return kernels_line


def run_alone(dev, card):
    """Phases 28-30 alone, with what they take from phases 1, 4, 22 and 26:
    the kernels they launch built, phase 4's ChEES run (seed 1), phase
    22's NUTS run on the dense path and phase 26's SMC runs.  Returns the
    slice's launches per rank."""
    import torch
    from george_tpu_torch import _build
    from george_tpu_torch.ops import dense, kalman
    from george_tpu_torch.samplers import build_gp_log_prob

    t_run = time.time()

    def phase(title):
        log("phase {0} (at {1:.1f} s)".format(title, time.time() - t_run))

    phase("1: the kernels of phases 28-30")
    f32 = torch.float32
    x, y, yerr = bench_data(N)
    gp = main_gp(dev)
    log_prob, theta0 = build_gp_log_prob(
        gp, x, y, yerr, log_prior=bench_prior(gp, dev, f32), device=dev,
        dtype=f32)
    xd, yd, yerrd = config5_data()
    gp5 = config5_gp(dev)
    dense_lp, dense_theta0 = build_gp_log_prob(
        gp5, xd, yd, yerrd, method="dense",
        log_prior=bench_prior(gp5, dev, f32), device=dev, dtype=f32)
    smc = smc_posterior(dev)
    _build.build_many(
        [vg.spec.instance(dt) for vg in (log_prob.kalman_vg,
                                         dense_lp.dense_vg, smc[1].dense_vg)
         for dt in (f32, torch.float64)]
        + [inst for _, _, inst in sharded_instances()])

    phase("4: the main path, ChEES over {0} chains, seed 1".format(CHAINS))
    z0 = theta0 + 0.1 * torch.as_tensor(
        np.random.default_rng(0).standard_normal((CHAINS, len(theta0))),
        device=dev, dtype=theta0.dtype)
    (chees,) = run_chees(log_prob, z0, (1,), kalman.kalman_vg, dev,
                         num_warmup=WARMUP, num_samples=SAMPLES,
                         num_leapfrog=MAX_LEAPFROG, block_size=BLOCK,
                         warmup_block_size=BLOCK)
    phase("22: NUTS on the dense path over {0} chains".format(DENSE_CHAINS))
    zd = dense_theta0 + 0.1 * torch.as_tensor(
        np.random.default_rng(0).standard_normal(
            (DENSE_CHAINS, len(dense_theta0))), device=dev,
        dtype=dense_theta0.dtype)
    (dr,) = run_sampler(dense_lp, zd, (5,), dense.dense_vg, dev, "nuts",
                        max_depth=NUTS_DEPTH, num_warmup=DENSE_NUTS_WARMUP,
                        num_samples=DENSE_NUTS_SAMPLES,
                        block_size=DENSE_NUTS_SAMPLES, warmup_block_size=BLOCK)
    smc_runs = run_smc_config3(phase, dev, card, smc)
    return run_sharded(phase, dev, card, z0, chees[0], zd, dr[0],
                       smc_runs["hmc"])


def run_examples_alone(dev, card):
    """Phase 31 alone, with the float64 instances it launches built first
    (all in parallel).  Returns its launches."""
    import torch
    from george_tpu_torch import _build
    from george_tpu_torch.samplers import build_gp_log_prob

    t0 = time.time()
    log("phase 1: the kernels of phase 31")
    x, y, yerr = bench_data(N)
    lp, _ = build_gp_log_prob(main_gp(dev), x, y, yerr, device=dev)
    xd, yd, yerrd = config5_data()
    dense_lp, _ = build_gp_log_prob(config5_gp(dev), xd, yd, yerrd,
                                    method="dense", device=dev)
    _build.build_many(
        [vg.spec.instance(torch.float64) for vg in (
            lp.kalman_vg, dense_lp.dense_vg, smc_posterior(dev)[1].dense_vg)]
        + [inst for _, _, inst in example_instances(dev)])
    log("  built in {0:.1f} s".format(time.time() - t0))
    return run_examples(
        lambda title: log("phase {0} (at {1:.1f} s)".format(
            title, time.time() - t0)), dev, card)


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
    alone = sys.argv[1:] == ["--phases", "28-30"]
    examples_alone = sys.argv[1:] == ["--phases", "31"]
    t0 = time.time()
    try:
        if alone:
            kernels = run_alone(dev, card)
        elif examples_alone:
            kernels = run_examples_alone(dev, card)
        else:
            kernels = run(dev, card)
    except Failure as exc:
        print("chip_smoke: FAILED: {0}".format(exc), file=sys.stderr)
        return 1
    log("all phases passed in {0:.1f} s".format(time.time() - t0))
    log(card)
    print(json.dumps({"sharded_launches_per_rank": kernels} if alone
                     else {"examples_launches": kernels} if examples_alone
                     else {"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
