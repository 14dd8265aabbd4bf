#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Where the samplers' time goes on the main path, on the CUDA card.

    python3 tools/sampler_timing.py [--root DIR] [--profile]

On ``chip_smoke.py``'s main path (16384 chains, N = 1000, float32):

* the wall time of phase 4's ChEES run (seed 1, 150 + 300 iterations) and
  its value+gradient calls (one Kalman launch each);
* with a package that has NUTS: ten ``nuts_step`` transitions and a
  20-draw ``nuts_draws_persistent`` block at max depth 4, each as wall
  milliseconds an iteration and, of it, the host time spent in the
  value+gradient call (its wrapper, the prior and the launch), on the
  clock without a device sync;
* with ``--profile``: ``torch.profiler``'s operator tables over five
  ``nuts_step`` transitions, by host time and by device time.

The package is imported from ``--root`` (default: this checkout); pointed
at an unpacked copy of another commit (``git archive <commit>
george_tpu_torch | tar -x -C DIR``), it times that commit's samplers with
this checkout's measurement, so that two versions are compared in one
call on one card: run parent, change, change, parent.  Card only.
"""

import argparse
import importlib
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose george_tpu_torch is timed")
    ap.add_argument("--profile", action="store_true",
                    help="print torch.profiler's tables of nuts_step")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import george_tpu_torch  # the package of --root

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(
        george_tpu_torch.__file__)))
    if pkg != root:
        raise SystemExit("george_tpu_torch came from {0}, not {1}".format(
            pkg, root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tools/sampler_timing.py measures the CUDA card; "
                         "none is visible")
    from george_tpu_torch.ops import kalman
    from george_tpu_torch.samplers import build_gp_log_prob, hmc

    sys.path.insert(1, HERE)
    smoke = importlib.import_module("chip_smoke")
    card = smoke.card_line()
    print(card)
    print("george_tpu_torch from {0}".format(root), flush=True)

    dev = torch.device("cuda", 0)
    x, y, yerr = smoke.bench_data(smoke.N)
    gp = smoke.main_gp(dev)
    log_prob, theta0 = build_gp_log_prob(
        gp, x, y, yerr, log_prior=smoke.bench_prior(gp, dev, torch.float32),
        device=dev, dtype=torch.float32)
    z0 = theta0 + 0.1 * torch.as_tensor(
        np.random.default_rng(0).standard_normal((smoke.CHAINS,
                                                  len(theta0))),
        device=dev, dtype=theta0.dtype)
    vg = log_prob.batched_value_and_grad
    vg(z0)                                   # build and load the kernel
    (res, seconds, launches), = smoke.run_chees(
        log_prob, z0, (1,), kalman.kalman_vg, dev,
        num_warmup=smoke.WARMUP, num_samples=smoke.SAMPLES,
        num_leapfrog=smoke.MAX_LEAPFROG, block_size=smoke.BLOCK,
        warmup_block_size=smoke.BLOCK)
    print("ChEES (phase 4, seed 1): wall {0:.3f} s, {1} value+gradient "
          "calls, {2:.4f} ms a call; on {3}".format(
              seconds, launches, seconds * 1e3 / launches, card), flush=True)

    try:
        from george_tpu_torch.samplers import nuts
    except ImportError:
        return
    host = {"calls": 0, "seconds": 0.0}

    def timed_vg(z):
        t = time.perf_counter()
        out = vg(z)
        host["seconds"] += time.perf_counter() - t
        host["calls"] += 1
        return out

    # At the posterior, with phase 20's step size and an inverse mass near
    # the posterior variances.
    st = hmc.HMCState(res.samples[:, -1].contiguous(),
                      *vg(res.samples[:, -1].contiguous()))
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    eps = torch.tensor(0.32, device=dev)
    inv_mass = res.samples.reshape(-1, res.samples.shape[-1]).var(0)
    for _ in range(3):
        st, _ = nuts.nuts_step(gen, st, timed_vg, eps, inv_mass, max_depth=4)
    for what, run in (
            ("nuts_step, 10 transitions", lambda: [nuts.nuts_step(
                gen, st, timed_vg, eps, inv_mass, max_depth=4)
                for _ in range(10)]),
            ("nuts_draws_persistent, 20 draws",
             lambda: nuts.nuts_draws_persistent(
                 gen, st, timed_vg, eps, inv_mass, 20, max_depth=4))):
        host.update(calls=0, seconds=0.0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        print("{0}: {1} iterations, {2:.3f} ms an iteration, of it {3:.3f} "
              "ms of host time in the value+gradient call; on {4}".format(
                  what, host["calls"], wall * 1e3 / host["calls"],
                  host["seconds"] * 1e3 / host["calls"], card), flush=True)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                st, _ = nuts.nuts_step(gen, st, vg, eps, inv_mass,
                                       max_depth=4)
            torch.cuda.synchronize()
        table = prof.key_averages()
        print(table.table(sort_by="self_cpu_time_total", row_limit=25))
        print(table.table(sort_by="self_device_time_total", row_limit=12))


if __name__ == "__main__":
    main()
