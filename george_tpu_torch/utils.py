# -*- coding: utf-8 -*-
"""Small host-side helpers (sampling, gradient checking).

API-compatible with george's ``utils.py`` (the JAX package's), except that
the draws come from an explicit ``torch.Generator`` (default: a freshly
seeded one) instead of the global ``np.random``.  The point orderings run
in the package's native C++ library (``native/src/ordering.cpp``).
"""

import numpy as np
import torch

from . import native

__all__ = ["multivariate_gaussian_samples", "standard_normal",
           "nd_sort_samples", "kd_sort_samples", "hilbert_sort_samples",
           "numerical_gradient", "check_gradient"]


def standard_normal(shape, generator=None):
    """Standard normal float64 draws of ``shape`` (numpy) from
    ``generator`` (default: a freshly seeded CPU generator)."""
    if generator is None:
        generator = torch.Generator()
        generator.seed()
    z = torch.randn(shape, generator=generator, dtype=torch.float64,
                    device=generator.device)
    return z.cpu().numpy()


def multivariate_gaussian_samples(matrix, N, mean=None, generator=None):
    """Draw ``N`` samples from N(mean, matrix); squeezed when ``N == 1``.

    The square root is ``V sqrt(max(w, 0))`` of the symmetric
    eigendecomposition ``matrix = V diag(w) V^T``, so a positive
    semi-definite matrix (a noiseless prior at close points) is fine.
    """
    matrix = np.asarray(matrix, dtype=np.float64)
    n = len(matrix)
    mean = np.zeros(n) if mean is None else np.asarray(mean, np.float64)
    w, V = np.linalg.eigh(matrix)
    root = V * np.sqrt(np.clip(w, 0.0, None))
    samples = mean + standard_normal((N, n), generator) @ root.T
    return samples[0] if N == 1 else samples


def nd_sort_samples(samples):
    """Order N-d samples by distance from the first sample (george's k-d
    tree query of every point, a sort by distance)."""
    assert len(samples.shape) == 2
    return native.distance_order(samples)


def kd_sort_samples(samples):
    """Recursive median-split ordering on the widest-spread axis: every
    halving separates two spatial clusters (the ordering a hierarchical
    solver wants)."""
    assert len(samples.shape) == 2
    return native.kd_order(samples)


def hilbert_sort_samples(samples, bits=16):
    """Hilbert space-filling-curve ordering of N-d samples."""
    assert len(samples.shape) == 2
    return native.hilbert_order(samples, bits=bits)


def numerical_gradient(f, x, dx=1.234e-6):
    """Centered finite-difference gradient of a scalar function."""
    g = np.empty_like(x, dtype=float)
    for i in range(len(g)):
        x[i] += dx
        fp = f(x)
        x[i] -= 2 * dx
        fm = f(x)
        x[i] += dx
        g[i] = 0.5 * (fp - fm) / dx
    return g


def check_gradient(obj, *args, **kwargs):
    """Assert a model's gradient against centered finite differences."""
    eps = kwargs.pop("eps", 1.23e-5)
    grad0 = obj.get_gradient(*args, **kwargs)
    vector = obj.get_parameter_vector()
    for i, v in enumerate(vector):
        vector[i] = v + eps
        obj.set_parameter_vector(vector)
        plus = obj.get_value(*args, **kwargs)

        vector[i] = v - eps
        obj.set_parameter_vector(vector)
        minus = obj.get_value(*args, **kwargs)

        vector[i] = v
        obj.set_parameter_vector(vector)

        fd = 0.5 * (plus - minus) / eps
        assert np.allclose(grad0[i], fd), (
            "grad computation failed for '{0}' ({1})".format(
                obj.get_parameter_names()[i], i
            )
        )
