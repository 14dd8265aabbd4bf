#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""The float32 state-space likelihood's error against float64, on the CPU.

    JAX_PLATFORMS=cpu python tools/kalman_float32_error.py

``bench.py``'s data (seed 42, N = 1000 sorted inputs, ``sin(x)`` + 0.1
noise) under the main path's kernel, ``1.0 * Matern32Kernel``, with the
white noise held at its starting 1e-4 (observation variance 0.1^2 + 1e-4),
over a grid of (log amplitude, log M) (the length scale is exp(log M / 2)).
For each point it prints |ll32 - ll64| of

* the port's sequential filter (``ops/state_space.kalman_loglike``), the
  plain version of ``csrc/kalman_vg.cu``;
* the port's associative-scan filter (``kalman_loglike_parallel``);
* the sequential filter given an exact process noise: Q formed in float64
  from the float32 parameters and gaps, rounded to float32, where the
  filter forms Q = Pinf - Phi Pinf Phi^T in float32;
* the JAX package's sequential state-space density
  (``build_gp_log_prob(method="state_space_sequential")``), float32 with
  x64 off and float64 with it on, each in a process of its own;

and the inf-norm gradient error of the port's sequential filter with its
own and with the exact Q.  The float64 reference is each filter's own.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

LOG_AMPS = (-2.0, -1.0, 0.0, 1.0)
LOG_MS = (0.0, 2.0, 3.0, 4.5, 6.0)
WHITE_NOISE = 1e-4


def data():
    rng = np.random.default_rng(42)
    x = np.sort(rng.uniform(0, 10, 1000))
    yerr = 0.1 * np.ones_like(x)
    y = np.sin(x) + yerr * rng.standard_normal(len(x))
    return x, y, yerr


def grid():
    return np.array([(a, m) for m in LOG_MS for a in LOG_AMPS])


def jax_lls(bits):
    """The JAX package's density on the grid, in this process (x64 as the
    caller set it through JAX_ENABLE_X64)."""
    import jax
    import george_tpu
    from george_tpu import kernels
    from george_tpu.samplers import build_gp_log_prob

    x, y, yerr = data()
    gp = george_tpu.GP(1.0 * kernels.Matern32Kernel(1.0),
                       white_noise=np.log(WHITE_NOISE))
    lp, _ = build_gp_log_prob(gp, x, y, yerr,
                              method="state_space_sequential")
    th = jax.numpy.asarray(grid(), dtype="float{0}".format(bits))
    out = jax.jit(jax.vmap(lp))(th)
    assert str(out.dtype) == "float{0}".format(bits), out.dtype
    return np.asarray(out, dtype=np.float64).tolist()


def jax_in_process(bits):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="1" if bits == 64 else "0")
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--jax",
                          str(bits)], env=env, capture_output=True,
                         text=True, check=True)
    return np.array(json.loads(out.stdout.strip().splitlines()[-1]))


def port_errors():
    import torch
    from george_tpu_torch import kernels
    from george_tpu_torch.ops import state_space as sskf

    torch.set_num_threads(1)
    x, y, yerr = data()
    terms = sskf.extract_terms((1.0 * kernels.Matern32Kernel(1.0))
                               .spec_node())
    systems = sskf._FilterMachine.systems

    def exact_q(self, sig_rates, dt):
        Phi, Q, Pinf = systems(self, sig_rates, dt)
        sr64 = [tuple(t.double() for t in pair) for pair in sig_rates]
        _, Q64, _ = systems(self, sr64, dt.double())
        return Phi, Q64.to(Q.dtype), Pinf

    def run(fn, dtype, exact=False):
        th = torch.tensor(grid(), dtype=dtype, requires_grad=True)
        dt, r, v = (torch.tensor(a, dtype=dtype) for a in (
            np.diff(x), y, yerr ** 2 + WHITE_NOISE))
        sskf._FilterMachine.systems = exact_q if exact else systems
        try:
            ll = fn(terms, th, dt, r, v)
            g, = torch.autograd.grad(ll.sum(), th)
        finally:
            sskf._FilterMachine.systems = systems
        return ll.detach().double().numpy(), g.double().numpy()

    out = {}
    for name, fn, exact in (
            ("sequential", sskf.kalman_loglike, False),
            ("parallel", sskf.kalman_loglike_parallel, False),
            ("sequential, exact Q", sskf.kalman_loglike, True)):
        l32, g32 = run(fn, torch.float32, exact)
        l64, g64 = run(fn, torch.float64)
        out[name] = (np.abs(l32 - l64), np.abs(g32 - g64).max(axis=1), l64)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--jax", type=int, choices=(32, 64),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.jax:
        print(json.dumps(jax_lls(args.jax)))
        return
    port = port_errors()
    jax_err = np.abs(jax_in_process(32) - jax_in_process(64))
    print("log amp  log M   |ll|     port seq  port par  exact Q   JAX seq "
          "  |grad err| seq  exact Q")
    for i, (a, m) in enumerate(grid()):
        print("{0:7.1f} {1:6.1f} {2:8.2f}  {3:.2e}  {4:.2e}  {5:.2e}  {6:.2e}"
              "  {7:.2e}       {8:.2e}".format(
                  a, m, abs(port["sequential"][2][i]),
                  port["sequential"][0][i], port["parallel"][0][i],
                  port["sequential, exact Q"][0][i], jax_err[i],
                  port["sequential"][1][i],
                  port["sequential, exact Q"][1][i]))


if __name__ == "__main__":
    main()
