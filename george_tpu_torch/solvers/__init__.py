# -*- coding: utf-8 -*-
"""Linear-algebra solvers for the GP covariance matrix.

This slice carries the dense Cholesky solver (:class:`BasicSolver`); the
trivial, HODLR and state-space solvers follow in later slices.
"""

from .basic import BasicSolver

__all__ = ["BasicSolver"]
