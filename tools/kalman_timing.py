#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Time the Kalman value+gradient kernel (``csrc/kalman_vg.cu``) of one
checkout's ``george_tpu_torch`` on the CUDA card.

    python3 tools/kalman_timing.py [--root DIR] [--reps 30] [--sweep]

Times the float32 kernel at ``chip_smoke.py``'s two Kalman shapes, the main
path (B = 16384 chains, N = 1000) and the long series (B = 1024,
N = 100,000), through ``build_gp_log_prob``'s engine as a sampler calls
it: the median over CUDA events of ``--reps`` launches after a warm-up,
beside the bound.  With ``--sweep``, and a package whose launcher splits a
series into segments, each segment count of ``chip_smoke.MAIN_SWEEP`` /
``LONG_SWEEP`` as well.  The package is imported from ``--root`` (default:
this checkout); pointed at an unpacked copy of another commit (``git
archive <commit> george_tpu_torch | tar -x -C DIR``), it times that
commit's kernel with this checkout's measurement, so that two versions are
compared in one run on one card: run parent, change, change, parent.
Prints the card's name and power limit, then a line a shape; the kernel is
built into ``DIR/build/`` at first use.  Card only.
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
    ap.add_argument("--sweep", action="store_true",
                    help="also time each forced segment count")
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
        raise SystemExit("tools/kalman_timing.py measures the CUDA card; "
                         "none is visible")
    from george_tpu_torch.ops import kalman
    from george_tpu_torch.samplers import build_gp_log_prob

    sys.path.insert(1, HERE)
    smoke = importlib.import_module("chip_smoke")
    card = smoke.card_line()
    print(card)
    print("george_tpu_torch from {0}".format(root), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    segmented = hasattr(kalman, "choose_segments")
    for what, (x, y, yerr), B, seed, sweep in (
            ("main path", smoke.bench_data(smoke.N), smoke.CHAINS, 7,
             smoke.MAIN_SWEEP),
            ("long series", smoke.stream_data(), smoke.LONG_CHAINS, 23,
             smoke.LONG_SWEEP)):
        gp = smoke.main_gp(dev)
        lp, _ = build_gp_log_prob(
            gp, x, y, yerr, log_prior=smoke.bench_prior(gp, dev,
                                                        torch.float32),
            device=dev, dtype=torch.float32)
        vg = lp.kalman_vg
        th = torch.as_tensor(smoke.full_thetas(gp, vg.spec.active, seed, B,
                                               0.1), device=dev)
        th = th.float().contiguous()
        label = "{0} float32 B={1} N={2}".format(what, B, len(x))
        if segmented:
            ms, _ = smoke.kalman_sweep(vg, th, sweep if args.sweep else (),
                                       args.reps, card, label)
        else:
            ms, ms_min = smoke.median_ms(lambda: vg(th), reps=args.reps)
            smoke.log("  {0}: median {1:.4f} ms (min {2:.4f}) over {3} "
                      "launches (one chain a thread); on {4}".format(
                          label, ms, ms_min, args.reps, card))
        bound, by = smoke.kalman_bound(vg.spec, B, len(x))
        smoke.log("  {0}: bound {1:.4f} ms set by {2}; kernel at {3:.1%} of "
                  "it".format(label, bound, by, bound / ms))
    return 0


if __name__ == "__main__":
    sys.exit(main())
