#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Time the dense value+gradient kernel (``csrc/dense_vg.cu``) of one
checkout's ``george_tpu_torch`` on the CUDA card.

    python3 tools/dense_vg_timing.py [--root DIR] [--reps 30]

Runs ``chip_smoke.time_dense`` (config #5's model at B = 4096 chains:
float32 and float64 at N = 128, float32 at N = 256; the median over CUDA
events of ``--reps`` launches after a warm-up, beside the bound) with the
package imported from ``--root`` (default: this checkout).  Pointed at an
unpacked copy of another commit (``git archive <commit> george_tpu_torch |
tar -x -C DIR``), it times that commit's kernel with this checkout's
measurement, so that two versions are compared in one run on one card:
run parent, change, change, parent.  (``chip_smoke.py`` phase 9 times
the plain version beside the kernel.)  Prints the card's name and power
limit, then one line a shape; the kernel is built into ``DIR/build/`` at
first use.  Card only.
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
    ap.add_argument("--reps", type=int, default=30)
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
        raise SystemExit("tools/dense_vg_timing.py measures the CUDA card; "
                         "none is visible")
    sys.path.insert(1, HERE)
    smoke = importlib.import_module("chip_smoke")
    card = smoke.card_line()
    print(card)
    print("george_tpu_torch from {0}".format(root), flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke.time_dense(dev, card, plain=False, reps=args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
