#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Time the covariance kernels (``csrc/stationary_cov.cu``: the forward
build and its VJP) of one checkout's ``george_tpu_torch`` on the CUDA card.

    python3 tools/cov_timing.py [--root DIR] [--reps 20]

Runs ``chip_smoke.time_cov_kernels`` (float32: the BASELINE model's
ExpSquared leaf at N = 16384, d = 1; config #5's Matern32 leaf at N = 8192,
d = 2; the vmapped sampler density's shape, 64 chains at N = 1024, on its
RationalQuadratic leaf and on config #5's leaf; the RationalQuadratic leaf
at N = 8192, where the dp tangents ride along; the median over CUDA events
of ``--reps`` calls after a warm-up, beside the bounds of
``chip_smoke.cov_fwd_bound`` / ``cov_bwd_bound``) with the package
imported from ``--root`` (default: this checkout).  Pointed at an unpacked
copy of another commit (``git archive <commit> george_tpu_torch | tar -x -C
DIR``), it times that commit's kernels with this checkout's measurement, so
that two versions are compared in one run on one card: run parent, change,
change, parent.  (``chip_smoke.py`` phase 14 times the plain versions
beside the kernels.)  Prints the card's name and power limit, then two
lines a shape; the kernels are built into ``DIR/build/`` at first use.
Card only.
"""

import argparse
import importlib
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose george_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
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
        raise SystemExit("tools/cov_timing.py measures the CUDA card; none "
                         "is visible")
    sys.path.insert(1, HERE)
    smoke = importlib.import_module("chip_smoke")
    card = smoke.card_line()
    print(card)
    print("george_tpu_torch from {0}".format(root), flush=True)
    smoke.time_cov_kernels(torch.device("cuda", 0), card, plain=False,
                           reps=args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
