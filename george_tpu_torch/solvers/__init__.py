# -*- coding: utf-8 -*-
"""Linear-algebra solvers for the GP covariance matrix.

  * :class:`TrivialSolver` — diagonal only (no kernel);
  * :class:`BasicSolver` — dense Cholesky, O(N^3);
  * :class:`StateSpaceSolver` — exact Kalman-filter solver, O(N), for 1-D
    Markovian kernels (Exp / Matern32 / Matern52 / Cosine / Constant sums).

The HODLR solver comes with a later slice.
"""

from .trivial import TrivialSolver
from .basic import BasicSolver
from .state_space import StateSpaceSolver

__all__ = ["TrivialSolver", "BasicSolver", "StateSpaceSolver"]
