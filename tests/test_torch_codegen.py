# -*- coding: utf-8 -*-
"""The CUDA code generated for kernel trees and for the radial functions of
stationary leaves (``dsl/cuda_codegen.py``), compiled with the host C++
compiler against a stub of the CUDA qualifiers
(``tests/cuda_host/cuda_host_stub.h``), against the port's torch builders:
values, slopes, and the forward-mode tangents of ``Dual<double, P>``
against autograd and the specs' ``grad:`` entries, including r2 = 0.
Skips without a host compiler."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from george_tpu_torch import kernels as tk
from george_tpu_torch.dsl import compiler, cuda_codegen
from george_tpu_torch.dsl.specs import available_kernels

# One intra-op thread: the tensors here are small, and the suite's workers
# run side by side (several threads each cost more than they gain).
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "george_tpu_torch", "csrc")


def _trees():
    """Every built-in spec, stationary ones under both metric types and a
    block window, and the dense sampler path's tree."""
    return {
        "constant": tk.ConstantKernel(log_constant=0.3, ndim=2),
        "cosine": tk.CosineKernel(log_period=0.4, ndim=2, axes=[1]),
        "dot_product": tk.DotProductKernel(ndim=2),
        "empty": tk.EmptyKernel(ndim=2),
        "exp": 0.7 * tk.ExpKernel(metric=[0.5, 1.5], ndim=2),
        "exp_sine2": tk.ExpSine2Kernel(gamma=1.2, log_period=0.3, ndim=2),
        "exp_squared": tk.ExpSquaredKernel(metric=0.8, ndim=2),
        "linear": tk.LinearKernel(log_gamma2=0.4, order=2.0, ndim=2),
        "linear_order0": tk.LinearKernel(log_gamma2=0.4, order=0.0, ndim=2),
        "local_gaussian": tk.LocalGaussianKernel(location=0.5, log_width=0.2,
                                                 ndim=2),
        "matern32": tk.Matern32Kernel(metric=[1.0, 2.0], ndim=2),
        "matern52_block": tk.Matern52Kernel(metric=1.3, ndim=2,
                                            block=[(-1.0, 1.5), (-2.0, 1.0)]),
        "polynomial": tk.PolynomialKernel(log_sigma2=0.1, order=3.0, ndim=2),
        "polynomial_half": tk.PolynomialKernel(log_sigma2=0.1, order=2.5,
                                               ndim=2),
        "rational_quadratic": tk.RationalQuadraticKernel(
            log_alpha=0.3, metric=[1.5, 0.7], ndim=2),
        "sum_product": 0.5 * tk.ExpSquaredKernel(metric=0.6, ndim=2)
        + tk.ConstantKernel(log_constant=-0.5, ndim=2)
        * tk.ExpKernel(metric=2.0, ndim=2, axes=[0]),
        "config5": 1.0 * tk.Matern32Kernel(metric=[1.0, 2.0], ndim=2,
                                           axes=[0, 1]),
    }


_EVAL = """
extern "C" void eval_{name}(const double* th, const double* x, int m,
                            double* primal, double* value, double* tangent) {{
  using D = gt::Dual<double, {np}>;
  D thd[{np} > 0 ? {np} : 1];
  for (int p = 0; p < {np}; ++p) {{
    thd[p] = gt::constant<double, {np}>(th[p]);
    thd[p].d[p] = 1.0;
  }}
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < m; ++j) {{
      const double* a = x + i * {ndim};
      const double* b = x + j * {ndim};
      primal[i * m + j] =
          gt::t_{name}::kernel_value<double, double>(th, a, b);
      D k = gt::t_{name}::kernel_value<double, D>(thd, a, b);
      value[i * m + j] = k.v;
      for (int p = 0; p < {np}; ++p) tangent[(i * m + j) * {np} + p] = k.d[p];
    }}
}}
"""


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("codegen")
    parts = ['#include "cuda_host_stub.h"', '#include "dual.cuh"']
    for name, k in _trees().items():
        node = k.spec_node()
        with open(os.path.join(out, name + ".cuh"), "w") as f:
            f.write(cuda_codegen.generate(node, namespace="t_" + name))
        parts += ['#include "{0}.cuh"'.format(name), "#undef GT_TREE_NP",
                  "#undef GT_TREE_NDIM",
                  _EVAL.format(name=name, np=compiler.node_size(node),
                               ndim=k.ndim)]
    src = os.path.join(out, "trees.cpp")
    with open(src, "w") as f:
        f.write("\n".join(parts))
    lib = os.path.join(out, "trees.so")
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC, "-I",
         os.path.join(HERE, "cuda_host"), "-I", str(out), "-o", lib, src],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ctypes.CDLL(lib)


@pytest.mark.parametrize("name", sorted(_trees()))
def test_generated_tree_matches_torch_builder(library, name):
    k = _trees()[name]
    node = k.spec_node()
    npar = compiler.node_size(node)
    rng = np.random.default_rng(3)
    # Points in and out of the block windows; the first two coincide, so
    # r2 = 0 off the diagonal as well as on it.
    x = rng.uniform(-2.0, 2.0, (6, k.ndim))
    if name == "polynomial_half":
        # A real power of a negative base is NaN, and autograd's NaN spreads
        # across the Jacobian's rows: keep the base positive.
        x = np.abs(x) + 0.1
    x[1] = x[0]
    theta = np.asarray(k.get_parameter_vector(include_frozen=True)) \
        + 0.1 * rng.standard_normal(npar)
    m = len(x)
    primal, value = np.empty((m, m)), np.empty((m, m))
    tangent = np.empty((m, m, max(npar, 1)))
    dbl = ctypes.POINTER(ctypes.c_double)
    getattr(library, "eval_" + name)(
        theta.ctypes.data_as(dbl), np.ascontiguousarray(x).ctypes.data_as(dbl),
        m, primal.ctypes.data_as(dbl), value.ctypes.data_as(dbl),
        tangent.ctypes.data_as(dbl))

    build = compiler.kernel_value_fn(node)
    X = torch.as_tensor(x)
    th = torch.as_tensor(theta)
    ref = build(th, X, X).detach().numpy()
    # The same closed forms in float64: agreement to rounding.
    np.testing.assert_allclose(primal, ref, rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(value, primal)
    if npar:
        jac = torch.autograd.functional.jacobian(
            lambda t: build(t, X, X), th).numpy()
        assert np.all(np.isfinite(tangent[..., :npar]))
        np.testing.assert_allclose(tangent[..., :npar], jac, rtol=1e-10,
                                   atol=1e-12)


def test_primal_ops_and_unsupported_trees():
    node = (1.0 * tk.Matern32Kernel(metric=[1.0, 2.0], ndim=3,
                                    axes=[0, 2])).spec_node()
    # exp(log c) x 3 axes, the axis-aligned r2, the Matern value, the
    # product: at least a couple of dozen operations.
    assert cuda_codegen.primal_ops(node) > 20
    general = tk.ExpSquaredKernel(metric=[[1.0, 0.1], [0.1, 2.0]], ndim=2)
    with pytest.raises(cuda_codegen.CodegenError, match="metric type 2"):
        cuda_codegen.generate(general.spec_node())


# -- the radial functions of the tiled covariance kernel ----------------------

def _radials():
    """Every stationary spec, as a leaf (its metric and axes do not enter
    the radial function)."""
    return {
        "exp": tk.ExpKernel(1.0),
        "exp_squared": tk.ExpSquaredKernel(1.0),
        "matern32": tk.Matern32Kernel(1.0),
        "matern52": tk.Matern52Kernel(1.0),
        "rational_quadratic": tk.RationalQuadraticKernel(log_alpha=0.3,
                                                         metric=1.0),
    }


_RADIAL_EVAL = """
extern "C" void radial_{name}(const double* p, const double* r2, int m,
                              double* value, double* slope,
                              double* tangent) {{
  for (int i = 0; i < m; ++i) {{
    value[i] = gt::r_{name}::radial_value<double, double>(p, r2[i]);
    slope[i] = gt::r_{name}::radial_slope<double>(p, r2[i]);
  }}
{tangents}
}}
"""

_RADIAL_TANGENTS = """
  using D = gt::Dual<double, {np}>;
  D pd[{np}];
  for (int q = 0; q < {np}; ++q) {{
    pd[q] = gt::constant<double, {np}>(p[q]);
    pd[q].d[q] = 1.0;
  }}
  for (int i = 0; i < m; ++i) {{
    D k = gt::r_{name}::radial_value<double, D>(pd, r2[i]);
    for (int q = 0; q < {np}; ++q) tangent[i * {np} + q] = k.d[q];
  }}
"""


@pytest.fixture(scope="module")
def radial_library(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("radial")
    parts = ['#include "cuda_host_stub.h"', '#include "dual.cuh"']
    for name, k in _radials().items():
        leaf = k.spec_node()
        with open(os.path.join(out, name + ".cuh"), "w") as f:
            f.write(cuda_codegen.generate_radial(leaf,
                                                 namespace="r_" + name))
        tangents = _RADIAL_TANGENTS.format(name=name, np=leaf.nparams) \
            if leaf.nparams else "  (void)tangent;"
        parts += ['#include "{0}.cuh"'.format(name), "#undef GT_RADIAL_NP",
                  _RADIAL_EVAL.format(name=name, tangents=tangents)]
    src = os.path.join(out, "radials.cpp")
    with open(src, "w") as f:
        f.write("\n".join(parts))
    lib = os.path.join(out, "radials.so")
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC, "-I",
         os.path.join(HERE, "cuda_host"), "-I", str(out), "-o", lib, src],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ctypes.CDLL(lib)


@pytest.mark.parametrize("name", sorted(_radials()))
def test_generated_radial_matches_torch(radial_library, name):
    """Value against the torch ``_radial_fn``, slope against the spec's
    ``grad: r2`` (and autograd of the bare value away from r2 = 0, where
    the Exp slope is guarded to 0), tangents against the spec's parameter
    ``grad:`` entries and autograd."""
    from george_tpu_torch.ops import cov

    leaf = _radials()[name].spec_node()
    npar = leaf.nparams
    r2 = np.array([0.0, 1e-20, 1e-6, 0.3, 1.0, 2.5, 9.0, 40.0])
    p = np.full(max(npar, 1), 0.3)
    m = len(r2)
    value, slope = np.empty(m), np.empty(m)
    tangent = np.empty((m, max(npar, 1)))
    dbl = ctypes.POINTER(ctypes.c_double)
    getattr(radial_library, "radial_" + name)(
        p.ctypes.data_as(dbl), r2.ctypes.data_as(dbl), m,
        value.ctypes.data_as(dbl), slope.ctypes.data_as(dbl),
        tangent.ctypes.data_as(dbl))

    radial = compiler._radial_fn(leaf.name, leaf.constants)
    pt = torch.tensor(p[:npar], requires_grad=True)
    rt = torch.tensor(r2, requires_grad=True)
    k = radial(pt, rt)
    np.testing.assert_allclose(value, k.detach().numpy(), rtol=1e-13)
    spec_slope, spec_grads = cov._spec_fns(leaf.name, leaf.constants)
    np.testing.assert_allclose(
        slope, np.broadcast_to(spec_slope(pt.detach(), rt.detach())
                               .numpy(), (m,)), rtol=1e-13)
    assert np.all(np.isfinite(slope))
    # The spec's slope against autograd of its bare value: away from
    # r2 = 0 (where sqrt's derivative diverges) they are one function.
    spec = available_kernels()[leaf.name]
    bare = compiler._compile_scalar_fn(spec, dict(leaf.constants), ("r2",),
                                       spec.value)
    away = r2 > 1e-3
    ra = torch.tensor(r2[away], requires_grad=True)
    d_r2, = torch.autograd.grad(bare(pt.detach(), ra).sum(), ra)
    np.testing.assert_allclose(slope[away], d_r2.numpy(), rtol=1e-12)
    if npar:
        ref = np.stack([np.broadcast_to(g(pt.detach(), rt.detach()).numpy(),
                                        (m,)) for g in spec_grads], axis=1)
        np.testing.assert_allclose(tangent[:, :npar], ref, rtol=1e-12,
                                   atol=1e-15)
        jac = torch.autograd.functional.jacobian(
            lambda q: radial(q, rt.detach()), pt.detach()).numpy()
        np.testing.assert_allclose(tangent[:, :npar], jac, rtol=1e-12,
                                   atol=1e-15)
    assert cuda_codegen.radial_ops(leaf)[0] >= 1
