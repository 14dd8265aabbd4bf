# -*- coding: utf-8 -*-
"""Defining a new kernel in the YAML DSL at runtime.

Parity with the reference's new-kernel tutorial
(docs/tutorials/new-kernel.rst), minus the C++ recompile: a spec registered
at runtime compiles straight to torch evaluators.

This example checks its gradients against finite differences, whose
tolerances assume double precision: the kernel is evaluated in float64 on
the card as on the CPU.

Run on the CUDA card (``--device cpu`` for the CPU):
``python examples_torch/05_new_kernel.py``
"""
import argparse
import os
import sys

import numpy as np
import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere without installing

from george_tpu_torch._device import resolve_device
from george_tpu_torch.dsl.specs import _parse_spec, available_kernels
from george_tpu_torch.kernels import _make_kernel_class
import george_tpu_torch.kernels as kernels_module

SPEC = """
name: MyLocalGaussianKernel
kernel_type: 100
stationary: false
params: [x0, log_w]
reparams:
  inv_2w: 0.5 * exp(-log_w)
value: exp(-((x1 - x0) ** 2 + (x2 - x0) ** 2) * inv_2w)
grad:
  x0: 2.0 * exp(-((x1 - x0) ** 2 + (x2 - x0) ** 2) * inv_2w) * inv_2w * ((x1 - x0) + (x2 - x0))
  log_w: exp(-((x1 - x0) ** 2 + (x2 - x0) ** 2) * inv_2w) * ((x1 - x0) ** 2 + (x2 - x0) ** 2) * inv_2w
  x1: -2.0 * exp(-((x1 - x0) ** 2 + (x2 - x0) ** 2) * inv_2w) * (x1 - x0) * inv_2w
  x2: -2.0 * exp(-((x1 - x0) ** 2 + (x2 - x0) ** 2) * inv_2w) * (x2 - x0) * inv_2w
doc: A local Gaussian window kernel (tutorial example).
"""


def main(device=None):
    device = resolve_device(device)
    spec = _parse_spec(yaml.safe_load(SPEC), "<inline>")
    available_kernels()[spec.name] = spec
    cls = _make_kernel_class(spec)
    setattr(kernels_module, spec.name, cls)

    k = cls(x0=0.5, log_w=0.1)
    x = np.random.default_rng(0).standard_normal((10, 1))
    K = k.get_value(x, device=device)
    print("K[0,0] = {0:.4f}".format(K[0, 0]))
    k.test_gradient(x, device=device)       # FD-check hyper gradients
    k.test_x1_gradient(x, device=device)    # FD-check input gradients
    print("gradient checks passed")
    return dict(K=K, gradient=k.get_gradient(x, device=device),
                x1_gradient=k.get_x1_gradient(x, device=device))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    main(parser.parse_args().device)
