# -*- coding: utf-8 -*-
"""Distance metrics for stationary kernels, and axis subspaces.

A :class:`Metric` turns a pair of input points into a squared distance
``r2``.  Three parameterizations are supported, matching george's metric
semantics:

  * ``metric_type == 0`` (isotropic): a single scalar ``M`` stored as
    ``log_M_0_0``;   ``r2 = |dx|^2 / M``.
  * ``metric_type == 1`` (axis-aligned): one scale per selected axis stored
    as ``log_M_i_i``;  ``r2 = sum_i dx_i^2 / M_i``.
  * ``metric_type == 2`` (general SPD matrix): parameterized by the lower
    Cholesky factor ``L`` of ``M`` with log-diagonal, packed row-major over
    the lower triangle;  ``r2 = dx^T M^{-1} dx = |L^{-1} dx|^2``.

The parameter vector layout for the general metric is the packed row-major
lower triangle ``[log L00, L10, log L11, L20, L21, log L22, ...]`` — the same
storage george uses in ``Metric.to_matrix``, so parameter vectors are
interchangeable.  (george's generated parameter *names* for n>=3 are known
to mislabel the off-diagonal entries; the same names are kept for
compatibility since only the vector layout affects numerics.)

The actual ``r2`` computation on device lives in
:func:`george_tpu_torch.dsl.compiler.metric_r2_matrix`; this class is
host-side parameter bookkeeping only (numpy, kept in step with the JAX
package's ``metrics.py``).
"""

import numpy as np

from .modeling import Model

__all__ = ["Metric", "Subspace"]


class Subspace(object):
    """A validated selection of input axes out of an ``ndim``-D space."""

    def __init__(self, ndim, axes=None):
        self.ndim = int(ndim)
        if axes is None:
            axes = np.arange(self.ndim)
        self.axes = np.atleast_1d(axes).astype(int)
        if np.any(self.axes >= self.ndim):
            raise ValueError(
                "invalid axis for {0} dimensional metric".format(self.ndim)
            )


def _general_metric_params(matrix):
    """Pack an SPD matrix into the [log-diag / off-diag] Cholesky vector."""
    L = np.linalg.cholesky(matrix)
    n = len(L)
    d = np.diag_indices(n)
    L[d] = np.log(L[d])
    return L[np.tril_indices(n)]


def general_metric_param_names(naxes):
    """Parameter names for the general metric (reference-compatible)."""
    names = []
    for i in range(naxes):
        names.append("log_L_{0}_{0}".format(i))
        for j in range(i + 1, naxes):
            names.append("L_{0}_{1}".format(i, j))
    return names


class Metric(Model):

    def __init__(self, metric, bounds=None, ndim=None, axes=None, lower=True):
        # Copy construction from another Metric.
        if isinstance(metric, Metric):
            self.metric_type = metric.metric_type
            self.parameter_names = metric.parameter_names
            self.unfrozen_mask = np.array(metric.unfrozen_mask)
            self.parameter_vector = metric.get_parameter_vector(
                include_frozen=True
            )
            self.parameter_bounds = list(metric.parameter_bounds)
            self.ndim = metric.ndim
            self.axes = metric.axes
            return

        if ndim is None:
            raise ValueError("missing required parameter 'ndim'")

        subspace = Subspace(ndim, axes=axes)
        self.ndim = subspace.ndim
        self.axes = subspace.axes

        names, values = self._parse_metric(metric)
        self.parameter_names = tuple(names)
        kwargs = dict(zip(names, values))
        if bounds is not None:
            kwargs["bounds"] = bounds
        super(Metric, self).__init__(**kwargs)

    def _parse_metric(self, metric):
        naxes = len(self.axes)
        try:
            scalar = float(metric)
        except TypeError:
            pass
        else:
            self.metric_type = 0
            return ["log_M_0_0"], [np.log(scalar)]

        metric = np.atleast_1d(metric)
        if metric.ndim == 1:
            self.metric_type = 1
            if len(metric) != naxes:
                raise ValueError("dimension mismatch")
            if np.any(metric <= 0.0):
                raise ValueError("invalid (negative) metric")
            names = ["log_M_{0}_{0}".format(i) for i in range(naxes)]
            return names, list(np.log(metric))

        if metric.ndim == 2:
            self.metric_type = 2
            if metric.shape[0] != metric.shape[1]:
                raise ValueError("metric must be square")
            if len(metric) != naxes:
                raise ValueError("dimension mismatch")
            return (
                general_metric_param_names(naxes),
                list(_general_metric_params(metric)),
            )

        raise ValueError("invalid metric dimensions")

    def to_matrix(self):
        """Reconstruct the dense metric matrix M from the parameter vector."""
        vector = self.get_parameter_vector(include_frozen=True)
        n = len(self.axes)
        if self.metric_type == 0:
            return np.exp(vector) * np.eye(n)
        if self.metric_type == 1:
            return np.diag(np.exp(vector))
        L = np.zeros((n, n))
        L[np.tril_indices(n)] = vector
        d = np.diag_indices(n)
        L[d] = np.exp(L[d])
        return np.dot(L, L.T)

    def __repr__(self):
        vector = self.get_parameter_vector(include_frozen=True)
        if self.metric_type == 0:
            head = "{0}".format(float(np.exp(vector[0])))
        elif self.metric_type == 1:
            head = repr(np.exp(vector))
        else:
            head = repr(self.to_matrix().tolist())
        bounds = [
            (None if a is None else np.exp(a), None if b is None else np.exp(b))
            for a, b in self.get_parameter_bounds(include_frozen=True)
        ]
        return "Metric({0}, ndim={1}, axes={2}, bounds={3})".format(
            head, self.ndim, repr(self.axes), bounds
        )
