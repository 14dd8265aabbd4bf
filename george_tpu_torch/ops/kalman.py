# -*- coding: utf-8 -*-
"""Fused Kalman-filter log-likelihood WITH gradient over a chain batch.

Counterpart of the JAX package's ``ops/pallas_kalman.py``.  The sampler hot
path is the value and gradient of the O(N) state-space marginal likelihood
for thousands of chains at once; :func:`make_kalman_vg` builds

    vg(theta_full (B, D_full)) -> (ll (B,), grad (B, n_active))

for the GP ``mean = mu (scalar), noise = yerr^2 + exp(wn), kernel = sum of
Markovian terms``, with the same signature and semantics as the reference.

Two implementations of that one function live here:

  * :func:`kalman_vg` — the hand-written CUDA kernel (``csrc/kalman_vg.cu``),
    one chain per thread, the filter state and its forward-mode tangents in
    registers, the series streamed through shared memory for every N up to
    :data:`MAX_N` (the reference's SMEM-resident and streaming kernels in
    one).  Its ``launches`` attribute counts kernel launches.
  * :func:`kalman_vg_torch` — the plain PyTorch version: the batched filter
    of :mod:`george_tpu_torch.ops.state_space` with the gradient from
    ``torch.autograd``.

``vg`` dispatches on the device of ``theta_full``: a CUDA tensor goes to the
kernel (which raises on anything it does not take), a CPU tensor to the
plain version.  There is no fallback between the two.
"""

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .. import _build
from .state_space import FAMILY_CODES, Term, extract_terms, kalman_loglike

__all__ = ["MAX_N", "KalmanSpec", "KalmanVG", "make_kalman_vg", "kalman_vg",
           "kalman_vg_torch"]

# The reference's longest series (pallas_kalman.MAX_N).  Its kernel keeps
# the series in SMEM up to 32768 steps and streams longer ones from HBM; the
# CUDA kernel streams every series through a double-buffered shared-memory
# window, so one kernel covers the whole range.
MAX_N = 1 << 22
# The kernel's term list is a decimal literal of one digit per term after a
# leading 1 (csrc/kalman_vg.cu, KV_FAMS), which a 64-bit integer holds.
MAX_TERMS = 17

SOURCE = "kalman_vg.cu"
_CTYPE = {torch.float32: "float", torch.float64: "double"}


@dataclass(frozen=True)
class KalmanSpec:
    """Static description of one fused value+gradient function.

    Parameter layout of ``theta_full``: [mean (n_mean in {0, 1}) |
    log white noise (n_wn in {0, 1}) | kernel parameters]; ``active`` lists
    the full-vector indices that get gradients.
    """

    terms: Tuple[Term, ...]
    n_mean: int
    n_wn: int
    active: Tuple[int, ...]
    d_full: int

    def defines(self, dtype):
        """The ``-D`` macros of the kernel instantiation for ``dtype``."""
        return {
            "KV_T": _CTYPE[dtype],
            "KV_NA": str(len(self.active)),
            "KV_FAMS": "1" + "".join(str(FAMILY_CODES[t.family])
                                     for t in self.terms),
        }

    def instance(self, dtype):
        """The kernel instantiation for ``dtype`` (:class:`_build.Instance`)."""
        return _build.Instance(SOURCE, self.defines(dtype))

    def meta(self):
        """The kernel's runtime description (see ``csrc/kalman_vg.cu``)."""
        off = self.n_mean + self.n_wn
        out = [self.n_mean, self.n_wn, len(self.active)] + list(self.active)
        for t in self.terms:
            out += [t.rate + off if t.rate >= 0 else -1, len(t.scales)]
            for naxes, i in t.scales:
                out += [naxes, i + off]
        return out


@lru_cache(maxsize=None)
def _meta_tensor(spec, device):
    return torch.tensor(spec.meta(), dtype=torch.int32, device=device)


def _library(spec, dtype):
    lib = _build.load(spec.instance(dtype))
    if not getattr(lib, "_kv_checked", False):
        lib.kalman_vg_launch.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.kalman_vg_launch.restype = ctypes.c_int
        lib.kalman_vg_error_string.argtypes = [ctypes.c_int]
        lib.kalman_vg_error_string.restype = ctypes.c_char_p
        lib.kalman_vg_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.kalman_vg_config.restype = None
        cfg = (ctypes.c_int * 4)()
        lib.kalman_vg_config(cfg)
        want = (sum(t.dim for t in spec.terms), len(spec.terms),
                len(spec.active), torch.empty((), dtype=dtype).element_size())
        if tuple(cfg) != want:
            raise RuntimeError("kalman_vg library {0} does not match the "
                               "spec {1}".format(tuple(cfg), want))
        lib._kv_checked = True
    return lib


def _check_inputs(spec, theta, dt, y, v):
    if theta.dtype not in _CTYPE:
        raise TypeError("theta must be float32 or float64, got "
                        "{0}".format(theta.dtype))
    if theta.dim() != 2 or theta.shape[1] != spec.d_full:
        raise ValueError("theta must be (B, {0}), got {1}".format(
            spec.d_full, tuple(theta.shape)))
    n = y.shape[0] if y.dim() == 1 else -1
    if not 1 <= n <= MAX_N:
        raise ValueError("series length must be in [1, {0}], got "
                         "{1}".format(MAX_N, n))
    for name, a, length in (("dt", dt, n - 1), ("y", y, n), ("v", v, n)):
        if a.dim() != 1 or a.shape[0] != length:
            raise ValueError("{0} must be ({1},), got {2}".format(
                name, length, tuple(a.shape)))
    for name, a in (("theta", theta), ("dt", dt), ("y", y), ("v", v)):
        if a.device != theta.device or a.dtype != theta.dtype:
            raise ValueError("{0} must be {1} on {2}".format(
                name, theta.dtype, theta.device))
        if not a.is_contiguous():
            raise ValueError("{0} must be contiguous".format(name))
    return n


def kalman_vg(spec, theta, dt, y, v):
    """Launch the CUDA kernel: ``(ll (B,), grad (B, n_active))``.

    All tensors must be contiguous CUDA tensors of one floating type.  The
    kernel runs on the current stream, without synchronisation.
    """
    if theta.device.type != "cuda":
        raise ValueError("kalman_vg launches a CUDA kernel; theta is on "
                         "{0}".format(theta.device))
    n = _check_inputs(spec, theta, dt, y, v)
    B = theta.shape[0]
    na = len(spec.active)
    ll = torch.empty(B, dtype=theta.dtype, device=theta.device)
    jac = torch.empty((na, B), dtype=theta.dtype, device=theta.device)
    if B == 0:
        return ll, jac.t()
    lib = _library(spec, theta.dtype)
    meta = _meta_tensor(spec, theta.device)
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        err = lib.kalman_vg_launch(
            theta.data_ptr(), dt.data_ptr(), y.data_ptr(), v.data_ptr(),
            meta.data_ptr(), ll.data_ptr(), jac.data_ptr(), B, n,
            spec.d_full, stream,
        )
    if err != 0:
        raise RuntimeError("kalman_vg launch failed: {0}".format(
            lib.kalman_vg_error_string(err).decode()))
    kalman_vg.launches += 1
    return ll, jac.t()


kalman_vg.launches = 0


def kalman_vg_torch(spec, theta, dt, y, v):
    """The plain PyTorch version of :func:`kalman_vg` (any device)."""
    _check_inputs(spec, theta, dt, y, v)
    n_scalar = spec.n_mean + spec.n_wn
    with torch.enable_grad():
        th = theta.detach().clone().requires_grad_(True)
        r = y - th[:, :1] if spec.n_mean else y
        var = v + torch.exp(th[:, spec.n_mean:spec.n_mean + 1]) \
            if spec.n_wn else v
        ll = kalman_loglike(spec.terms, th[:, n_scalar:], dt, r, var)
        if spec.active:
            g = torch.autograd.grad(ll.sum(), th)[0][:, list(spec.active)]
        else:
            g = th.new_zeros(th.shape[0], 0)
    return ll.detach(), g


class KalmanVG(object):
    """``vg(theta_full (B, D_full)) -> (ll (B,), grad (B, n_active))``.

    The time-sorted dataset is baked in; gaps are differenced in float64
    BEFORE the cast to the working type (float32 resolution at large |t|,
    e.g. astronomical epochs ~2.45e6, is coarser than typical cadences, and
    only the differences enter the filter).
    """

    def __init__(self, spec, t, y, yerr2):
        self.spec = spec
        self._host = (np.diff(np.asarray(t, np.float64)),
                      np.asarray(y, np.float64), np.asarray(yerr2, np.float64))
        self._series = {}

    def series(self, like):
        """The (dt, y, v) series on ``like``'s device, in its dtype."""
        key = (like.device, like.dtype)
        if key not in self._series:
            self._series[key] = tuple(
                torch.as_tensor(a, device=like.device).to(like.dtype)
                .contiguous() for a in self._host
            )
        return self._series[key]

    def __call__(self, theta_full):
        dt, y, v = self.series(theta_full)
        if theta_full.device.type == "cuda":
            return kalman_vg(self.spec, theta_full.contiguous(), dt, y, v)
        if theta_full.device.type == "cpu":
            return kalman_vg_torch(self.spec, theta_full, dt, y, v)
        raise ValueError("no Kalman engine for device {0}".format(
            theta_full.device))


def make_kalman_vg(node, t, y, yerr2, n_mean, n_wn, active):
    """Build ``vg(theta_full_b) -> (ll (B,), grad (B, n_active))``.

    :param node: kernel spec tree (must support the state-space form).
    :param t,y,yerr2: the *time-sorted* dataset (host arrays, baked in).
    :param n_mean,n_wn: 1 if the mean / log-white-noise is a per-chain
        scalar parameter (ConstantModel), else 0 (baked into ``y`` /
        ``yerr2``).
    :param active: tuple of full-vector indices needing gradients.
    """
    n = int(len(t))
    if n > MAX_N:
        raise ValueError("series of length {0} is longer than the fused "
                         "Kalman kernel takes ({1})".format(n, MAX_N))
    terms = tuple(extract_terms(node))
    if len(terms) > MAX_TERMS:
        raise ValueError("the fused Kalman kernel takes at most {0} terms, "
                         "got {1}".format(MAX_TERMS, len(terms)))
    from ..dsl.compiler import node_size

    d_full = int(n_mean) + int(n_wn) + node_size(node)
    active = tuple(int(a) for a in active)
    if any(not 0 <= a < d_full for a in active):
        raise ValueError("active indices {0} out of range for {1} "
                         "parameters".format(active, d_full))
    spec = KalmanSpec(terms, int(n_mean), int(n_wn), active, d_full)
    return KalmanVG(spec, t, y, yerr2)
