# -*- coding: utf-8 -*-
"""The port's kernel gradients over the JAX package's kernel zoo.

The zoo and the checks are tests/test_kernels.py's: ``Kernel.test_gradient``,
``test_x1_gradient`` and ``test_x2_gradient`` hold the port's forward-mode
gradient tensors (``dsl/compiler.kernel_gradient_fn``,
``kernel_x1_gradient_fn``, ``kernel_x2_gradient_fn``) to centred
differences of the port's own ``get_value``, in float64 on the CPU, over
multi-dimensional inputs, axis subsets, sums and negative parameters, and
the stationary kernels over a sweep of metrics, axes and a block.
tests/test_torch_gp_api.py holds the same tensors to the JAX package's.

At most four test functions, each looping over its cases: pytest-xdist's
``--dist loadfile`` hands out the files with more tests first, and this
one is to come after the suite's long files.
"""

import numpy as np
import pytest
import torch

from george_tpu_torch import kernels

# One intra-op thread: the tensors here are small, and the suite's workers
# run side by side.
torch.set_num_threads(1)


ZOO = [
    kernels.ConstantKernel(log_constant=0.1),
    kernels.ConstantKernel(log_constant=10.0, ndim=2),
    kernels.ConstantKernel(log_constant=5.0, ndim=5),

    kernels.DotProductKernel(),
    kernels.DotProductKernel(ndim=2),
    kernels.DotProductKernel(ndim=5, axes=0),

    kernels.CosineKernel(log_period=1.0),
    kernels.CosineKernel(log_period=0.5, ndim=2),
    kernels.CosineKernel(log_period=0.5, ndim=2, axes=1),
    kernels.CosineKernel(log_period=0.75, ndim=5, axes=[2, 3]),

    kernels.ExpSine2Kernel(gamma=0.4, log_period=1.0),
    kernels.ExpSine2Kernel(gamma=12.0, log_period=0.5, ndim=2),
    kernels.ExpSine2Kernel(gamma=17.0, log_period=0.5, ndim=2, axes=1),
    kernels.ExpSine2Kernel(gamma=13.7, log_period=-0.75, ndim=5,
                           axes=[2, 3]),
    kernels.ExpSine2Kernel(gamma=-0.7, log_period=0.75, ndim=5,
                           axes=[2, 3]),
    kernels.ExpSine2Kernel(gamma=-10, log_period=0.75),

    kernels.LocalGaussianKernel(log_width=0.5, location=1.0),
    kernels.LocalGaussianKernel(log_width=0.1, location=0.5, ndim=2),
    kernels.LocalGaussianKernel(log_width=1.5, location=-0.5, ndim=2,
                                axes=1),
    kernels.LocalGaussianKernel(log_width=2.0, location=0.75, ndim=5,
                                axes=[2, 3]),

    kernels.LinearKernel(order=0, log_gamma2=0.0),
    kernels.LinearKernel(order=2, log_gamma2=0.0),
    kernels.LinearKernel(order=5, log_gamma2=1.0, ndim=2),
    kernels.LinearKernel(order=3, log_gamma2=-1.0, ndim=5, axes=2),
    kernels.LinearKernel(order=0, log_gamma2=0.0)
    + kernels.LinearKernel(order=1, log_gamma2=-1.0)
    + kernels.LinearKernel(order=2, log_gamma2=-2.0),

    kernels.PolynomialKernel(order=0, log_sigma2=-10.0),
    kernels.PolynomialKernel(order=2, log_sigma2=-10.0),
    kernels.PolynomialKernel(order=2, log_sigma2=0.0),
    kernels.PolynomialKernel(order=5, log_sigma2=1.0, ndim=2),
    kernels.PolynomialKernel(order=3, log_sigma2=-1.0, ndim=5, axes=2),

    12.0 * kernels.ExpSine2Kernel(gamma=0.4, log_period=1.0, ndim=5),
    12.0 * kernels.ExpSquaredKernel(0.4, ndim=3) + 0.1,
]


def _check_gradients(kernel, N=20, seed=123, eps=1.32e-6):
    np.random.seed(seed)
    t1 = np.random.randn(N, kernel.ndim)
    kernel.test_gradient(t1, eps=eps, device="cpu")
    kernel.test_gradient(t1, t1[:1], eps=eps, device="cpu")


def _check_x_gradients(kernel, N=20, seed=123, eps=1.32e-6):
    np.random.seed(seed)
    t1 = np.random.randn(N, kernel.ndim)
    kernel.test_x1_gradient(t1, eps=eps, device="cpu")
    kernel.test_x1_gradient(t1, np.array(t1[:1]), eps=eps, device="cpu")
    kernel.test_x2_gradient(t1, eps=eps, device="cpu")
    kernel.test_x2_gradient(np.array(t1[:1]), t1, eps=eps, device="cpu")


def _each(check, kernels_):
    """Run ``check`` on every kernel, naming the first that fails."""
    for i, kernel in enumerate(kernels_):
        try:
            check(kernel)
        except Exception as err:
            raise AssertionError("case {0}: {1!r}".format(i, kernel)) \
                from err


def test_kernel_gradients():
    _each(_check_gradients, ZOO)


def test_kernel_x_gradients():
    _each(_check_x_gradients, ZOO)


STATIONARY = [
    (kernels.ExpKernel, {}),
    (kernels.ExpSquaredKernel, {}),
    (kernels.Matern32Kernel, {}),
    (kernels.Matern52Kernel, {}),
    (kernels.RationalQuadraticKernel, dict(log_alpha=np.log(1.0))),
    (kernels.RationalQuadraticKernel, dict(log_alpha=np.log(0.1))),
    (kernels.RationalQuadraticKernel, dict(log_alpha=np.log(10.0))),
]


def test_stationary_metric_sweep():
    for kernel_type, kwargs in STATIONARY:
        def build(metric, **more):
            return kernel_type(metric=metric, **dict(kwargs, **more))

        with pytest.raises(ValueError):
            build([1.0, 0.1, 10.0, 500], ndim=3)

        sweep = [build(metric) for metric in (0.1, 1.0, 10.0)] + [
            build([1.0, 0.1, 10.0], ndim=3),
            build(1.0, ndim=3),
            build(1.0, ndim=3, axes=2),
            build(1.0, ndim=3, axes=2, block=(-0.1, 0.1)),
        ]
        _each(lambda k: (_check_gradients(k), _check_x_gradients(k)), sweep)


def test_kernel_without_parameters():
    # A kernel with no parameters, or with all of them frozen, has an
    # (N1, N2, 0) gradient tensor, as the JAX package's has.
    x1 = np.random.default_rng(4).standard_normal((6, 2))
    x2 = x1[:3]
    dot = kernels.DotProductKernel(ndim=2)
    assert dot.get_gradient(x1, x2, device="cpu").shape == (6, 3, 0)
    assert dot.get_gradient(x1, x2, include_frozen=True,
                            device="cpu").shape == (6, 3, 0)
    k = 2.0 * kernels.ExpSquaredKernel(1.5, ndim=2)
    k.freeze_all_parameters()
    assert k.get_gradient(x1, device="cpu").shape == (6, 6, 0)
    full = k.get_gradient(x1, x2, include_frozen=True, device="cpu")
    assert full.shape == (6, 3, len(k.get_parameter_vector(
        include_frozen=True)))
    k.thaw_all_parameters()
    np.testing.assert_array_equal(k.get_gradient(x1, x2, device="cpu"), full)
