# -*- coding: utf-8 -*-
"""Linear-algebra solvers for the GP covariance matrix.

  * :class:`TrivialSolver` — diagonal only (no kernel);
  * :class:`BasicSolver` — dense Cholesky, O(N^3);
  * :class:`HODLRSolver` — hierarchical off-diagonal low-rank
    factorization, O(N log^2 N), approximate to its ``tol``;
  * :class:`StateSpaceSolver` — exact Kalman-filter solver, O(N), for 1-D
    Markovian kernels (Exp / Matern32 / Matern52 / Cosine / Constant sums).
"""

from .trivial import TrivialSolver
from .basic import BasicSolver
from .hodlr import HODLRSolver
from .state_space import StateSpaceSolver

__all__ = ["TrivialSolver", "BasicSolver", "HODLRSolver", "StateSpaceSolver"]
