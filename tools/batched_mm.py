#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Batched (B, N, N) @ (B, N, N)^T on the CUDA card: the hand-written
kernel against PyTorch's batched matrix product.

    python3 tools/batched_mm.py [--b 4096] [--n 128] [--rep 20]

The port of the JAX package's ``benchmarks/pallas_batched_mm.py``: the same
arguments, the same inputs (``default_rng(0)`` standard normals, float32)
and the same line format, ``name: ms  TFLOP/s`` with 2 B N^3 operations.
The lines:

  * ``matmul``     — ``torch.matmul(a, b.transpose(1, 2))`` in full FP32
    (TF32 off), the library call (the TPU script's ``xla`` line);
  * ``kernelC``    — ``ops/batched_mm.batched_mmT`` (``csrc/batched_mmT.cu``)
    with C chains a thread block, for each C of ``--chains`` (the TPU
    script's chunk / batchdim sweep).

Each repetition perturbs the input (``a + i * 1e-6``, made before the
timed region) and is timed alone with CUDA events; the line is the median
over ``--rep`` repetitions after one warm-up.  It runs on the card only.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from george_tpu_torch.ops import batched_mm  # noqa: E402


def measure(b=4096, n=128, rep=20, chains=batched_mm.CHAINS_PER_BLOCK,
            device=None):
    """Time the library call and the kernel at each chain count.

    :returns: ``{name: (median ms, TFLOP/s)}`` in the order measured.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("tools/batched_mm.py measures the CUDA card; "
                           "none is visible")
    dev = torch.device(device or "cuda")
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((b, n, n)), dtype=torch.float32,
                        device=dev)
    bm = torch.as_tensor(rng.standard_normal((b, n, n)), dtype=torch.float32,
                         device=dev)
    flops = 2.0 * b * n * n * n
    m = torch.backends.cuda.matmul
    saved = m.allow_tf32
    m.allow_tf32 = False

    def bench(fn):
        fn(a, bm)
        times = []
        for i in range(rep):
            ai = a + (i + 1) * 1e-6
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(ai, bm)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = float(np.median(times))
        return ms, flops / (ms * 1e-3) / 1e12

    out = {}
    try:
        out["matmul"] = bench(lambda x, y: torch.matmul(x, y.transpose(1, 2)))
        for c in chains:
            out["kernel{0}".format(c)] = bench(
                lambda x, y, c=c: batched_mm.batched_mmT(x, y, c))
    finally:
        m.allow_tf32 = saved
    return out


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi: " + out.stderr.strip()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--b", type=int, default=4096)
    p.add_argument("--n", type=int, default=128)
    p.add_argument("--rep", type=int, default=20)
    p.add_argument("--chains", type=int, nargs="+",
                   choices=batched_mm.CHAINS_PER_BLOCK,
                   default=list(batched_mm.CHAINS_PER_BLOCK))
    args = p.parse_args()
    print(card_line())
    for name, (ms, tflops) in measure(args.b, args.n, args.rep,
                                      args.chains).items():
        print("{0:12s}: {1:7.3f} ms  {2:6.2f} TFLOP/s".format(
            name, ms, tflops))


if __name__ == "__main__":
    main()
