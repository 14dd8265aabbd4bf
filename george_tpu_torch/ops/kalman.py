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
    the filter state and its forward-mode tangents in registers, the series
    streamed through shared memory for every N up to :data:`MAX_N` (the
    reference's SMEM-resident and streaming kernels in one).  Each chain's
    series is split in time over S segments, one warp each, the warps of
    32 chains one thread-block cluster (S = 1: one chain a thread);
    :func:`choose_segments` picks S.  Its ``launches`` attribute counts
    kernel launches, one a call.
  * :func:`kalman_vg_torch` — the plain PyTorch version: the batched filter
    of :mod:`george_tpu_torch.ops.state_space` with the gradient in forward
    mode, as the kernel carries it (the tangents on the complex step).

:func:`kalman_vg_segmented_torch` models the kernel's split in PyTorch for
the tests; nothing on the card's path calls it.

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
from .state_space import (FAMILY_CODES, Term, _FilterMachine, extract_terms,
                          kalman_loglike)

__all__ = ["MAX_N", "KalmanSpec", "KalmanVG", "make_kalman_vg", "kalman_vg",
           "kalman_vg_torch", "kalman_vg_segmented_torch", "segment_bounds",
           "choose_segments", "cluster_shape"]

# The reference's longest series (pallas_kalman.MAX_N).  Its kernel keeps
# the series in SMEM up to 32768 steps and streams longer ones from HBM; the
# CUDA kernel streams every series through a double-buffered shared-memory
# window, so one kernel covers the whole range.
MAX_N = 1 << 22
# The kernel's term list is a decimal literal of one digit per term after a
# leading 1 (csrc/kalman_vg.cu, KV_FAMS), which a 64-bit integer holds.
MAX_TERMS = 17

# A launch over S > 1 segments runs S / cluster warps a block in clusters
# of `cluster` blocks (csrc/kalman_vg.cu, KS_MAX_WARPS and KS_MAX_CLUSTER).
MAX_WARPS = 8
MAX_CLUSTER = 16
# Blocks of this many warps where the cluster size allows: on the H100, 16
# blocks of 4 warps took 7.8211 ms at S = 64 where 8 of 8 took 8.7059, and
# 8 of 4 8.7623 ms at S = 32 where 4 of 8 took 10.5880 (B = 1024,
# N = 100,000; PERF.md).
BLOCK_WARPS = 4
# An instance of a larger state dimension is held to S = 1: its segment
# kernel spills heavily and takes minutes to build (csrc/kalman_vg.cu,
# KS_MAX_D; PERF.md).
MAX_SPLIT_DIM = 4

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

    @property
    def dim(self):
        """The state dimension."""
        return sum(t.dim for t in self.terms)

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
        lib.kalman_vg_launch.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.kalman_vg_launch.restype = ctypes.c_int
        lib.kalman_vg_scratch_words.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.kalman_vg_scratch_words.restype = ctypes.c_longlong
        lib.kalman_vg_error_string.argtypes = [ctypes.c_int]
        lib.kalman_vg_error_string.restype = ctypes.c_char_p
        lib.kalman_vg_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.kalman_vg_config.restype = None
        cfg = (ctypes.c_int * 4)()
        lib.kalman_vg_config(cfg)
        want = (spec.dim, len(spec.terms),
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


def cluster_shape(segments):
    """``(blocks a cluster, warps a block)`` of a launch over ``segments``
    segments: blocks of :data:`BLOCK_WARPS` warps or fewer where at most
    :data:`MAX_CLUSTER` of them take every segment, else of up to
    :data:`MAX_WARPS`."""
    for limit in (BLOCK_WARPS, MAX_WARPS):
        for warps in range(min(limit, segments), 0, -1):
            if segments % warps == 0 and segments // warps <= MAX_CLUSTER:
                return segments // warps, warps
    raise ValueError("{0} segments do not split into at most {1} blocks of "
                     "at most {2} warps".format(segments, MAX_CLUSTER,
                                                MAX_WARPS))


# The launcher's rule, from the float32 kernel on an NVIDIA H100 80GB HBM3
# at 700 W, ms by S = 1, 2, 4, 8, 16, 32, 64, 128 (one call; PERF.md):
#   B = 16384, N = 1000:    0.649  0.925  0.698  0.929  0.984  1.418 ...
#   B = 4096,  N = 1000:    0.585  0.598  0.371  0.298  0.305  0.478 ...
#   B = 1024,  N = 1000:    0.634  0.633  0.422  0.344  0.226  0.238 ...
#   B = 1024,  N = 100000:  53.30  51.79  31.37  23.92  12.73  10.57  8.69 7.41
#   B = 32,    N = 100000:  53.34  51.82  31.37  23.94  12.78  6.65  3.47 1.96
# and in a later call, with blocks of 4 warps (BLOCK_WARPS) and segments of
# equal length: B = 4096, N = 1000: S = 8 0.296, 16 0.363; B = 1024,
# N = 100,000: S = 32 7.908, 64 6.811, 128 6.990.
# One chain a thread fills the card from 16384 chains (128 blocks); past
# that a split only adds its ~2x operations.  Below it the split pays until
# ~1024 warps (8 an SM) keep the card issuing; more segments then pay only
# where they stay long (512 observations or more), up to 2048 warps.  A
# segment keeps 32 observations or more (the prefix of stage 2 grows with
# S), and S = 2 shortens nothing.
FILL_CHAINS = 16384
BUSY_WARPS = 1024
MAX_SPLIT_WARPS = 2048
LONG_SEGMENT = 512
MIN_SEGMENT = 32
MAX_SEGMENTS = 128


def choose_segments(B, n, dim):
    """The kernel's segment count S for B chains over a series of n
    observations of a state of ``dim`` dimensions (the chip table above)."""
    if dim > MAX_SPLIT_DIM or B >= FILL_CHAINS:
        return 1
    groups = -(-B // 32)
    S = 1
    while 2 * S <= MAX_SEGMENTS and n // (2 * S) >= MIN_SEGMENT:
        warps = groups * 2 * S
        if warps > MAX_SPLIT_WARPS or (warps > BUSY_WARPS and
                                       n // (2 * S) < LONG_SEGMENT):
            break
        S *= 2
    return S if S >= 4 else 1


def kalman_vg(spec, theta, dt, y, v, segments=None):
    """Launch the CUDA kernel: ``(ll (B,), grad (B, n_active))``.

    All tensors must be contiguous CUDA tensors of one floating type.  The
    kernel runs on the current stream, without synchronisation.
    ``segments`` splits each chain's series over that many warps (for tests
    and timing); by default :func:`choose_segments` picks it.
    """
    if theta.device.type != "cuda":
        raise ValueError("kalman_vg launches a CUDA kernel; theta is on "
                         "{0}".format(theta.device))
    n = _check_inputs(spec, theta, dt, y, v)
    B = theta.shape[0]
    na = len(spec.active)
    S = choose_segments(B, n, spec.dim) if segments is None \
        else int(segments)
    if S < 1:
        raise ValueError("segments must be >= 1, got {0}".format(S))
    if S > 1 and spec.dim > MAX_SPLIT_DIM:
        raise ValueError("a state of {0} dimensions is held to segments=1 "
                         "(at most {1} split)".format(spec.dim,
                                                      MAX_SPLIT_DIM))
    ll = torch.empty(B, dtype=theta.dtype, device=theta.device)
    jac = torch.empty((na, B), dtype=theta.dtype, device=theta.device)
    if B == 0:
        return ll, jac.t()
    lib = _library(spec, theta.dtype)
    meta = _meta_tensor(spec, theta.device)
    # One chain a thread needs no scratch, and no host work for it: the
    # main path's launches follow each other closely.
    cluster, scratch = 1, None
    if S > 1:
        cluster = cluster_shape(S)[0]
        scratch = torch.empty(lib.kalman_vg_scratch_words(B, S),
                              dtype=theta.dtype, device=theta.device)
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        err = lib.kalman_vg_launch(
            theta.data_ptr(), dt.data_ptr(), y.data_ptr(), v.data_ptr(),
            meta.data_ptr(), ll.data_ptr(), jac.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, n,
            spec.d_full, S, cluster, stream,
        )
    if err != 0:
        raise RuntimeError("kalman_vg launch failed: {0}".format(
            lib.kalman_vg_error_string(err).decode()))
    kalman_vg.launches += 1
    return ll, jac.t()


kalman_vg.launches = 0


# The complex step of :func:`_value_and_grad` by working type: far below
# the type's resolution of the parameters, far above its smallest normal.
_COMPLEX_STEP = {torch.float32: 1e-10, torch.float64: 1e-20}
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _value_and_grad(spec, theta, y, v, loglike):
    """``loglike(th_kernel, r, var) -> ll (B,)`` at the residuals and the
    variances of the spec's layout, with its gradient with respect to the
    active parameters in forward mode, as the kernel carries it.

    The tangents ride on the complex step: the batch is repeated once an
    active parameter, each copy's parameter takes an imaginary step h, and
    the filter runs once over the copies in complex arithmetic.  Every
    operation of the filter is analytic, so a copy's Im(ll) / h is the
    derivative along its parameter (no difference is taken, so nothing
    cancels; the error is O(h^2)): the arithmetic of the kernel's dual
    numbers (``Dual<T, NA>``), in the working type's precision.  In float64
    the value is the real part of one more, unperturbed copy; in float32
    it comes from the filter in real arithmetic, whose rounding the float32
    kernel is held to (complex products round differently).
    """
    B, na = theta.shape[0], len(spec.active)
    n_scalar = spec.n_mean + spec.n_wn

    def run(th):
        r = y - th[:, :1] if spec.n_mean else y
        var = v + torch.exp(th[:, spec.n_mean:spec.n_mean + 1]) \
            if spec.n_wn else v
        with torch.no_grad():
            return loglike(th[:, n_scalar:], r, var)

    theta = theta.detach()
    real_value = theta.dtype != torch.float64
    if real_value or not na:
        ll = run(theta)
        if not na:
            return ll, theta.new_zeros(B, 0)
    step = _COMPLEX_STEP[theta.dtype]
    first = 0 if real_value else 1
    th = theta.repeat(na + first, 1).to(_COMPLEX[theta.dtype])
    for i, a in enumerate(spec.active):
        th[(i + first) * B:(i + first + 1) * B, a] += 1j * step
    out = run(th)
    if not real_value:
        ll = out.real[:B].contiguous()
    grad = (out.imag[first * B:] / step).reshape(na, B).t()
    return ll, grad.contiguous()


def kalman_vg_torch(spec, theta, dt, y, v):
    """The plain PyTorch version of :func:`kalman_vg` (any device): the
    sequential filter of :mod:`george_tpu_torch.ops.state_space`, its
    gradient carried forward beside it (:func:`_value_and_grad`)."""
    _check_inputs(spec, theta, dt, y, v)
    return _value_and_grad(spec, theta, y, v, lambda th, r, var:
                           kalman_loglike(spec.terms, th, dt, r, var))


def segment_bounds(n, segments):
    """``[0, s_1, ..., s_{S-1}, n]``: the first observation of each of the
    kernel's segments (``csrc/kalman_vg.cu``, ``seg_start``), then n.

    S segments of equal length; segment 0 always holds observation 0, later
    segments may be empty when n < S.
    """
    return [0] + [max(1, s * n // segments)
                  for s in range(1, segments)] + [n]


def _fold(fm, E, Phi_k, Q_k, r_k, v_k):
    """Append one observation to a segment's element ``E = (A, b, C, eta,
    J)``: the combine of :func:`state_space.combine` with a one-step right
    operand, written as the kernel runs it.  (b, C) take the filter's
    predict and Joseph update; A is carried through the same gain; the
    one-step J is rank one, so no solve is needed."""
    A, b, C, eta, J = E
    b, C = fm.predict(b, C, Phi_k, Q_k)
    A = Phi_k @ A
    w = A.transpose(-1, -2) @ fm.h            # H A, (B, D)
    b, C, K, innov, S = fm.gain_update(b, C, r_k, v_k)
    inv = 1.0 / S
    A = A - K[:, :, None] * w[:, None, :]
    J = J + w[:, :, None] * w[:, None, :] * inv[:, None, None]
    eta = eta + w * (innov * inv)[:, None]
    return A, b, C, eta, J


def _apply(E, m, P):
    """The filtered state (m, P) carried through a segment's element: the
    combine of the state (as the element (0, m, P, 0, 0)) with ``E``."""
    A, b, C, eta, J = E
    D = m.shape[-1]
    eye = torch.eye(D, dtype=m.dtype, device=m.device)
    R = torch.linalg.solve(eye + P @ J, torch.cat(
        [P, (m + (P @ eta[..., None])[..., 0])[..., None]], dim=-1))
    m = (A @ R[..., D:])[..., 0] + b
    X = A @ R[..., :D] @ A.transpose(-1, -2) + C
    # The kernel forms the lower triangle and mirrors it.
    lower = torch.ones(D, D, dtype=torch.bool, device=m.device).tril()
    return m, torch.where(lower, X, X.transpose(-1, -2))


def _segmented_loglike(terms, th_kernel, dt, r, v, segments):
    """ll (B,) by the kernel's three stages over ``segments`` segments."""
    fm = _FilterMachine(terms, th_kernel)
    B = th_kernel.shape[0]
    n = dt.shape[0] + 1
    r = torch.broadcast_to(r, (B, n))
    v = torch.broadcast_to(v, (B, n))
    Phi, Q, Pinf = fm.systems(fm.sig_rates(th_kernel), dt)
    bounds = segment_bounds(n, segments)

    def refilter(m, P, acc, first, last):
        for k in range(first, last):
            m, P = fm.predict(m, P, Phi[k - 1], Q[k - 1])
            m, P, acc = fm.obs_update(m, P, r[:, k], v[:, k], acc)
        return m, P, acc

    # Stage 1: segment 0 filters from the stationary prior to the state at
    # its end; every other segment but the last folds its element.
    zero = th_kernel.new_zeros(B)
    m, P, acc0 = fm.obs_update(th_kernel.new_zeros(B, fm.D), Pinf, r[:, 0],
                               v[:, 0], zero)
    state = refilter(m, P, acc0, 1, bounds[1])
    elements = {}
    for s in range(1, segments - 1):
        if bounds[s] == bounds[s + 1]:
            continue
        E = (fm.eye.expand(B, fm.D, fm.D), th_kernel.new_zeros(B, fm.D),
             th_kernel.new_zeros(B, fm.D, fm.D), th_kernel.new_zeros(B, fm.D),
             th_kernel.new_zeros(B, fm.D, fm.D))
        for k in range(bounds[s], bounds[s + 1]):
            E = _fold(fm, E, Phi[k - 1], Q[k - 1], r[:, k], v[:, k])
        elements[s] = E
    # Stages 2 and 3: each segment carries segment 0's end state through
    # the elements before it, then re-filters its own observations.
    ll = state[2]
    for s in range(1, segments):
        if bounds[s] == bounds[s + 1]:
            continue
        m, P = state[:2]
        for k in range(1, s):
            if k in elements:
                m, P = _apply(elements[k], m, P)
        ll = ll + refilter(m, P, zero, bounds[s], bounds[s + 1])[2]
    return ll


def kalman_vg_segmented_torch(spec, theta, dt, y, v, segments):
    """A plain PyTorch model of the kernel's split of the series into
    ``segments`` segments (any device; for tests).

    Stage 1: segment 0 runs the filter; every later segment but the last
    folds its observations into one element of the associative-scan filter
    (:func:`state_space.combine`), conditioned on the state before it.
    Stage 2: each segment carries segment 0's end state through the
    elements before its own, in order.  Stage 3: each segment re-filters its
    observations from that state, and the segments' sums of prediction-error
    terms add up in segment order.  The gradient is in forward mode, as
    :func:`kalman_vg_torch`'s.
    """
    _check_inputs(spec, theta, dt, y, v)
    if segments < 1:
        raise ValueError("segments must be >= 1, got {0}".format(segments))
    return _value_and_grad(spec, theta, y, v, lambda th, r, var:
                           _segmented_loglike(spec.terms, th, dt, r, var,
                                              segments))


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
