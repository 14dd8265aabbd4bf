# -*- coding: utf-8 -*-
"""george_tpu_torch — the PyTorch / CUDA port of george_tpu.

Gaussian-process regression with the YAML kernel DSL, the ``GP`` object,
and a sampler layer whose hot paths, the batched value and gradient of the
state-space (Kalman) and small dense likelihoods, are CUDA kernels written
by hand for Hopper (``csrc/kalman_vg.cu``, ``csrc/dense_vg.cu``, and the
spine of the opt-in blocked dense engine, ``csrc/dense_spine.cu``); large
stationary covariance builds and their gradients go through another
(``csrc/stationary_cov.cu``).  The solvers (trivial, dense, HODLR and the
O(N) state-space one) are exported here, ``optimize`` is loaded on first
use.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "kernels",
    "GP",
    "Metric",
    "TrivialSolver",
    "BasicSolver",
    "HODLRSolver",
    "StateSpaceSolver",
    "optimize",
]

from . import kernels
from .gp import GP
from .metrics import Metric
from .solvers import (
    TrivialSolver, BasicSolver, HODLRSolver, StateSpaceSolver
)


def __getattr__(name):
    # Lazy, as the JAX package loads its optimizer.
    if name == "optimize":
        import importlib

        module = importlib.import_module(".optimize", __name__)
        globals()["optimize"] = module
        return module
    raise AttributeError(name)
