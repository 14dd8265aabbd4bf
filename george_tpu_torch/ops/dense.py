# -*- coding: utf-8 -*-
"""Fused batched dense-GP log-likelihood WITH gradient over a chain batch.

Counterpart of the JAX package's ``ops/pallas_dense.py``.  The sampler hot
path of a posterior whose kernel has no state-space form (multi-dimensional
inputs, subspace metrics, ExpSquared, ...) is the value and gradient of the
dense marginal likelihood for thousands of chains at small N;
:func:`make_dense_batched_vg` builds

    vg(theta_full (B, D_full)) -> (ll (B,), grad (B, n_active))

for ``K = k(theta; X, X) + diag(yerr^2 + exp(wn))``, ``r = y - mean``,
``ll = -0.5 (N log 2 pi + log det K + r^T K^-1 r)``, NaN where K is not
positive definite, with the same signature and semantics as the reference.

Two implementations of that one function live here:

  * :func:`dense_vg` — the hand-written CUDA kernel (``csrc/dense_vg.cu``),
    one thread block per chain over packed 16 x 16 tiles of K (N padded to
    a multiple of 16 with the identity); the kernel tree is compiled in,
    generated by :mod:`george_tpu_torch.dsl.cuda_codegen`.  Its
    ``launches`` attribute counts kernel launches.
  * :func:`dense_vg_torch` — the plain PyTorch version: a batched K, a
    ``cholesky_ex``, alpha and the log-determinant, with the gradient from
    ``torch.autograd`` (the kernel uses the closed form
    0.5 tr[(alpha alpha^T - K^-1) dK]; the two agree to rounding).

``vg`` dispatches on the device of ``theta_full``: a CUDA tensor goes to the
kernel (which raises on anything it does not take), a CPU tensor to the
plain version.  There is no fallback between the two.
"""

import ctypes
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .. import _build
from ..dsl import compiler, cuda_codegen
from ..dsl.compiler import Op
from . import linalg

__all__ = ["MAX_N", "DenseSpec", "DenseVG", "supports_dense",
           "make_dense_batched_vg", "dense_vg", "dense_vg_torch"]

# The reference kernel's envelope (pallas_dense.MAX_N).
MAX_N = 256

SOURCE = "dense_vg.cu"
_CTYPE = {torch.float32: "float", torch.float64: "double"}
_LOG_2PI = math.log(2.0 * math.pi)


def supports_dense(node, n):
    """True when the kernel tree and problem size fit the fused engine:
    N <= MAX_N and every stationary leaf uses an isotropic or axis-aligned
    metric (``pallas_dense.supports_pallas_dense``)."""
    if n > MAX_N:
        return False

    def ok(nd):
        if isinstance(nd, Op):
            return ok(nd.k1) and ok(nd.k2)
        return (not nd.stationary) or nd.metric_type in (0, 1)

    return ok(node)


@lru_cache(maxsize=None)
def _tree_header(node):
    return cuda_codegen.generate(node)


@dataclass(frozen=True)
class DenseSpec:
    """Static description of one fused value+gradient function.

    Parameter layout of ``theta_full``: [mean (n_mean in {0, 1}) |
    log white noise (n_wn in {0, 1}) | kernel parameters]; ``active`` lists
    the full-vector indices that get gradients.
    """

    node: object
    n_mean: int
    n_wn: int
    active: Tuple[int, ...]
    d_full: int

    def instance(self, dtype):
        """The kernel instantiation for ``dtype`` (:class:`_build.Instance`):
        scalar type and tangent count as macros, the generated tree as the
        header ``dense_tree.cuh``."""
        return _build.Instance(
            SOURCE, {"DV_T": _CTYPE[dtype], "DV_NA": str(len(self.active))},
            {"dense_tree.cuh": _tree_header(self.node)})

    def meta(self):
        """The kernel's runtime description (see ``csrc/dense_vg.cu``)."""
        return [self.n_mean, self.n_wn, len(self.active)] + list(self.active)


@lru_cache(maxsize=None)
def _meta_tensor(spec, device):
    return torch.tensor(spec.meta(), dtype=torch.int32, device=device)


def _library(spec, dtype):
    lib = _build.load(spec.instance(dtype))
    if not getattr(lib, "_dv_checked", False):
        lib.dense_vg_launch.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.dense_vg_launch.restype = ctypes.c_int
        lib.dense_vg_error_string.argtypes = [ctypes.c_int]
        lib.dense_vg_error_string.restype = ctypes.c_char_p
        lib.dense_vg_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.dense_vg_config.restype = None
        lib.dense_vg_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.dense_vg_smem_bytes.restype = ctypes.c_longlong
        lib.dense_vg_workspace_words.argtypes = [ctypes.c_int]
        lib.dense_vg_workspace_words.restype = ctypes.c_longlong
        lib.dense_vg_max_smem.argtypes = []
        lib.dense_vg_max_smem.restype = ctypes.c_int
        cfg = (ctypes.c_int * 5)()
        lib.dense_vg_config(cfg)
        want = (len(spec.active), compiler.node_size(spec.node),
                _ndim(spec.node), torch.empty((), dtype=dtype).element_size())
        if tuple(cfg)[:4] != want:
            raise RuntimeError("dense_vg library {0} does not match the "
                               "spec {1}".format(tuple(cfg)[:4], want))
        lib._dv_checked = True
    return lib


def _ndim(node):
    if isinstance(node, Op):
        return max(_ndim(node.k1), _ndim(node.k2))
    return node.ndim


def _check_inputs(spec, theta, x, y, v):
    if theta.dtype not in _CTYPE:
        raise TypeError("theta must be float32 or float64, got "
                        "{0}".format(theta.dtype))
    if theta.dim() != 2 or theta.shape[1] != spec.d_full:
        raise ValueError("theta must be (B, {0}), got {1}".format(
            spec.d_full, tuple(theta.shape)))
    n = y.shape[0] if y.dim() == 1 else -1
    if not 1 <= n <= MAX_N:
        raise ValueError("N must be in [1, {0}], got {1}".format(MAX_N, n))
    if x.dim() != 2 or x.shape != (n, _ndim(spec.node)):
        raise ValueError("x must be ({0}, {1}), got {2}".format(
            n, _ndim(spec.node), tuple(x.shape)))
    if v.shape != (n,):
        raise ValueError("v must be ({0},), got {1}".format(n, tuple(v.shape)))
    for name, a in (("theta", theta), ("x", x), ("y", y), ("v", v)):
        if a.device != theta.device or a.dtype != theta.dtype:
            raise ValueError("{0} must be {1} on {2}".format(
                name, theta.dtype, theta.device))
        if not a.is_contiguous():
            raise ValueError("{0} must be contiguous".format(name))
    return n


def dense_vg(spec, theta, x, y, v):
    """Launch the CUDA kernel: ``(ll (B,), grad (B, n_active))``.

    All tensors must be contiguous CUDA tensors of one floating type.  The
    kernel runs on the current stream, without synchronisation.
    """
    if theta.device.type != "cuda":
        raise ValueError("dense_vg launches a CUDA kernel; theta is on "
                         "{0}".format(theta.device))
    n = _check_inputs(spec, theta, x, y, v)
    B = theta.shape[0]
    na = len(spec.active)
    ll = torch.empty(B, dtype=theta.dtype, device=theta.device)
    jac = torch.empty((na, B), dtype=theta.dtype, device=theta.device)
    if B == 0:
        return ll, jac.t()
    lib = _library(spec, theta.dtype)
    meta = _meta_tensor(spec, theta.device)
    with torch.cuda.device(theta.device):
        words = _workspace_words(lib, n, spec.d_full)
        ws = None
        if words:
            # torch's allocator aligns the workspace to far more than the
            # 16 bytes the kernel's tile reads need; each chain's slice is
            # a multiple of 16 bytes.
            ws = torch.empty(B * words, dtype=theta.dtype,
                             device=theta.device)
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        err = lib.dense_vg_launch(
            theta.data_ptr(), x.data_ptr(), y.data_ptr(), v.data_ptr(),
            meta.data_ptr(), ll.data_ptr(), jac.data_ptr(), B, n,
            spec.d_full, None if ws is None else ws.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError("dense_vg launch failed: {0}".format(
            lib.dense_vg_error_string(err).decode()))
    dense_vg.launches += 1
    return ll, jac.t()


dense_vg.launches = 0


def _workspace_words(lib, n, d_full):
    """Words of device workspace a chain: 0 when the packed 16 x 16 tiles
    of K and the vectors fit a block's shared memory on the current device,
    else the tiles' (shared memory then holds the vectors only).  Raises
    when not even the vectors fit."""
    limit = lib.dense_vg_max_smem()
    if lib.dense_vg_smem_bytes(n, d_full, 1) <= limit:
        return 0
    if lib.dense_vg_smem_bytes(n, d_full, 0) > limit:
        raise ValueError("N={0} needs more shared memory than a block has "
                         "({1} bytes)".format(n, limit))
    return lib.dense_vg_workspace_words(n)


def gp_loglike(node, th_kernel, x, r, noise):
    """Per-chain dense GP log-likelihood of residuals ``r`` (B, N) under
    ``K = k(th_kernel; x, x) + diag(noise)`` (noise (B, N) or (N,)),
    differentiable by autograd; NaN where K is not positive definite."""
    build = compiler.kernel_value_fn(node)
    K = torch.func.vmap(build, in_dims=(0, None, None))(th_kernel, x, x)
    K = K + torch.diag_embed(torch.broadcast_to(noise, K.shape[:-1]))
    L, logdet = linalg.cholesky_factor(K)
    r = torch.broadcast_to(r, K.shape[:-1])
    alpha = linalg.cho_solve(L, r)
    return -0.5 * (x.shape[0] * _LOG_2PI + logdet
                   + torch.sum(r * alpha, dim=-1))


def dense_loglike(spec, theta, x, y, v):
    """:func:`gp_loglike` over the fused engine's parameter layout."""
    m, n_scalar = spec.n_mean, spec.n_mean + spec.n_wn
    r = y - theta[:, :1] if m else y
    noise = v + torch.exp(theta[:, m:m + 1]) if spec.n_wn else v
    return gp_loglike(spec.node, theta[:, n_scalar:], x, r, noise)


def dense_vg_torch(spec, theta, x, y, v):
    """The plain PyTorch version of :func:`dense_vg` (any device)."""
    _check_inputs(spec, theta, x, y, v)
    with torch.enable_grad():
        th = theta.detach().clone().requires_grad_(True)
        ll = dense_loglike(spec, th, x, y, v)
        if spec.active:
            g = torch.autograd.grad(ll.sum(), th)[0][:, list(spec.active)]
        else:
            g = th.new_zeros(th.shape[0], 0)
    ll = ll.detach()
    g = torch.where(torch.isnan(ll)[:, None], torch.full_like(g, np.nan), g)
    return ll, g


class DenseVG(object):
    """``vg(theta_full (B, D_full)) -> (ll (B,), grad (B, n_active))`` with
    the dataset baked in (cast to each call's dtype and device once)."""

    def __init__(self, spec, x, y, yerr2):
        self.spec = spec
        self._host = tuple(np.array(a, np.float64) for a in (x, y, yerr2))
        self._data = {}

    def data(self, like):
        """The (x, y, v) data on ``like``'s device, in its dtype."""
        key = (like.device, like.dtype)
        if key not in self._data:
            self._data[key] = tuple(
                torch.as_tensor(a, device=like.device).to(like.dtype)
                .contiguous() for a in self._host
            )
        return self._data[key]

    def __call__(self, theta_full):
        x, y, v = self.data(theta_full)
        if theta_full.device.type == "cuda":
            return dense_vg(self.spec, theta_full.contiguous(), x, y, v)
        if theta_full.device.type == "cpu":
            return dense_vg_torch(self.spec, theta_full, x, y, v)
        raise ValueError("no dense engine for device {0}".format(
            theta_full.device))


def make_dense_batched_vg(node, x, y, yerr2, n_mean, n_wn, active):
    """Build ``vg(theta_full_b) -> (ll (B,), grad (B, n_active))``.

    :param node: kernel spec tree (``supports_dense`` must hold).
    :param x: (N, d) coordinates (host array, baked in).
    :param y: observations with any parameter-free mean already subtracted.
    :param yerr2: per-point noise variances with any parameter-free
        white-noise model already folded in.
    :param n_mean,n_wn: 1 if the mean / log-white-noise is a per-chain
        scalar parameter (ConstantModel), else 0.
    :param active: tuple of full-vector indices needing gradients.
    """
    x = np.atleast_2d(np.asarray(x, np.float64))
    n = x.shape[0]
    if not supports_dense(node, n):
        raise ValueError("the fused dense engine takes N <= {0} and metric "
                         "types 0/1 (N={1})".format(MAX_N, n))
    if x.shape[1] != _ndim(node):
        raise ValueError("x has {0} columns, the kernel {1} dimensions"
                         .format(x.shape[1], _ndim(node)))
    d_full = int(n_mean) + int(n_wn) + compiler.node_size(node)
    active = tuple(int(a) for a in active)
    if any(not 0 <= a < d_full for a in active):
        raise ValueError("active indices {0} out of range for {1} "
                         "parameters".format(active, d_full))
    spec = DenseSpec(node, int(n_mean), int(n_wn), active, d_full)
    return DenseVG(spec, x, y, yerr2)
