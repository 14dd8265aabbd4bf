# -*- coding: utf-8 -*-
"""Tiled stationary covariance build with a hand-written vector-Jacobian
product.

Counterpart of the JAX package's ``ops/pallas_cov.py``.  For one stationary
leaf, on coordinates already mapped through the leaf's metric (so that
``r2 = |a1 - a2|^2``), :func:`make_stationary_cov` returns a
``torch.autograd.Function`` computing

    K[..., i, j] = k(p; sum_d (a1_id - a2_jd)^2)

for the radial parameters ``p`` (NP,), ``A1`` (N1, d) and ``A2`` (N2, d),
each with an optional leading batch dimension (the vmapped sampler
density).  Its backward is the closed form: with ``W = g * dk/d(r2)``,
``dp_q = sum g dk/dp_q``, ``dA1 = 2 (rowsum(W) A1 - W @ A2)`` and
``dA2 = 2 (colsum(W) A2 - W^T @ A1)``; the metric's own parameters get
their gradients by autograd through the transform applied outside
(``dsl/compiler.py``).

Two implementations of each direction live here:

  * :func:`stationary_cov_fwd` / :func:`stationary_cov_bwd` — the
    hand-written CUDA kernels (``csrc/stationary_cov.cu``), the radial
    function compiled in, generated by
    :func:`george_tpu_torch.dsl.cuda_codegen.generate_radial` from the
    spec's ``value:`` and ``grad: r2:``.  Each has a ``launches`` count: one
    per call.  A forward call is one grid launch; a backward call is the
    number :func:`bwd_grid_launches` gives (the library's own count: a pass
    over g that reduces each tile along both axes, then one finalize).
  * :func:`stationary_cov_torch` / :func:`stationary_cov_vjp_torch` — the
    plain PyTorch versions; the VJP takes dp from the spec's parameter
    ``grad:`` entries, independent of the kernel's forward-mode tangents.

:func:`stationary_cov_vjp_tiles_torch` repeats the backward kernel's
tiling in plain PyTorch (row bands, in-tile sums in the working type,
per-band column partials, the finalize in band order), so that the CPU
tests can hold the kernel's algorithm to the plain VJP.

The Function dispatches on the device of its inputs: CUDA tensors go to
the kernels (which raise on what they do not take), CPU tensors to the
plain versions.  There is no fallback between the two.

Deliberate difference from the TPU kernel: that kernel casts to float32
(``pallas_cov.py:181-183``), a limit of its chip; the kernel here has a
float64 instance as well, which ``config.pallas_covariance = "always"``
routes float64 builds to and the checks hold to the plain version at
rtol 1e-9.
"""

import ctypes
from functools import lru_cache

import torch

from .. import _build
from ..dsl import compiler, cuda_codegen
from ..dsl.specs import available_kernels

__all__ = ["make_stationary_cov", "stationary_cov", "stationary_cov_vjp",
           "stationary_cov_fwd", "stationary_cov_bwd", "bwd_grid_launches",
           "bwd_plan",
           "stationary_cov_torch", "stationary_cov_vjp_torch",
           "stationary_cov_vjp_tiles_torch", "instance"]

SOURCE = "stationary_cov.cu"
_CTYPE = {torch.float32: "float", torch.float64: "double"}
# The backward kernel's tile: BAND rows by 512 bytes of columns (128
# float32 or 64 float64: 16 bytes a lane, 32 lanes).
BAND = 64


@lru_cache(maxsize=None)
def _radial_header(leaf):
    return cuda_codegen.generate_radial(leaf)


def instance(leaf, dtype):
    """The kernel instantiation for ``leaf`` in ``dtype``
    (:class:`_build.Instance`): the scalar type and the coordinate count as
    macros, the radial function as the generated header ``radial.cuh``."""
    return _build.Instance(
        SOURCE, {"SC_T": _CTYPE[dtype], "SC_NDIM": str(len(leaf.axes))},
        {"radial.cuh": _radial_header(leaf)})


def _library(leaf, dtype):
    lib = _build.load(instance(leaf, dtype))
    if not getattr(lib, "_sc_checked", False):
        ptr = ctypes.c_void_p
        lib.sc_fwd_launch.argtypes = [ptr] * 4 + [ctypes.c_int] * 3 + [ptr]
        lib.sc_fwd_launch.restype = ctypes.c_int
        lib.sc_bwd_launch.argtypes = [ptr] * 8 + [ctypes.c_int] * 3 + [ptr]
        lib.sc_bwd_launch.restype = ctypes.c_int
        lib.sc_bwd_workspace_words.argtypes = [ctypes.c_int] * 3
        lib.sc_bwd_workspace_words.restype = ctypes.c_longlong
        lib.sc_bwd_grid_launches.argtypes = [ctypes.c_int] * 3
        lib.sc_bwd_grid_launches.restype = ctypes.c_int
        lib.sc_bwd_plan.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.sc_bwd_plan.restype = None
        lib.sc_error_string.argtypes = [ctypes.c_int]
        lib.sc_error_string.restype = ctypes.c_char_p
        lib.sc_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.sc_config.restype = None
        lib.sc_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.sc_limits.restype = None
        cfg = (ctypes.c_int * 3)()
        lib.sc_config(cfg)
        want = (len(leaf.axes), leaf.nparams,
                torch.empty((), dtype=dtype).element_size())
        if tuple(cfg) != want:
            raise RuntimeError("stationary_cov library {0} does not match "
                               "the leaf {1}".format(tuple(cfg), want))
        limits = (ctypes.c_int * 3)()
        lib.sc_limits(limits)
        lib._sc_limits = tuple(limits)
        lib._sc_checked = True
    return lib


def _shapes(leaf, p, A1, A2, g=None):
    """Check the inputs; ``(batched, B, N1, N2)``."""
    if A1.dtype not in _CTYPE:
        raise TypeError("coordinates must be float32 or float64, got "
                        "{0}".format(A1.dtype))
    batched = A1.dim() == 3
    lead = (A1.shape[0],) if batched else ()
    d, npar = len(leaf.axes), leaf.nparams
    if A1.dim() not in (2, 3) or A1.shape[-1] != d:
        raise ValueError("A1 must be (N1, {0}) or (B, N1, {0}), got "
                         "{1}".format(d, tuple(A1.shape)))
    n1 = A1.shape[-2]
    if A2.shape[:-2] != lead or A2.dim() != A1.dim() or A2.shape[-1] != d:
        raise ValueError("A2 must be {0}(N2, {1}), got {2}".format(
            "(B, ...)" if batched else "", d, tuple(A2.shape)))
    n2 = A2.shape[-2]
    if tuple(p.shape) != lead + (npar,):
        raise ValueError("p must be {0}, got {1}".format(lead + (npar,),
                                                         tuple(p.shape)))
    if g is not None and tuple(g.shape) != lead + (n1, n2):
        raise ValueError("g must be {0}, got {1}".format(lead + (n1, n2),
                                                         tuple(g.shape)))
    for name, a in (("p", p), ("A2", A2), ("g", g)):
        if a is not None and (a.dtype != A1.dtype or a.device != A1.device):
            raise ValueError("{0} must be {1} on {2}".format(
                name, A1.dtype, A1.device))
    return batched, (lead[0] if batched else 1), n1, n2


def _device_args(leaf, p, A1, A2, B):
    """Contiguous (B, PS), (B, N1, d), (B, N2, d) tensors for the kernel;
    a leaf without radial parameters gets a dummy (B, 1) ``p``."""
    if leaf.nparams == 0:
        p = torch.zeros((B, 1), dtype=A1.dtype, device=A1.device)
    return (p.reshape(B, -1).contiguous(),
            A1.reshape(B, A1.shape[-2], -1).contiguous(),
            A2.reshape(B, A2.shape[-2], -1).contiguous())


def _check_launch(lib, err, what):
    if err != 0:
        raise RuntimeError("stationary_cov {0} launch failed: {1}".format(
            what, lib.sc_error_string(err).decode()))


def _check_limits(lib, B, n1, n2):
    max_n1, max_n2, max_b = lib._sc_limits
    if n1 > max_n1 or n2 > max_n2 or B > max_b:
        raise ValueError("stationary_cov takes N1 <= {0}, N2 <= {1} and B "
                         "<= {2}; got ({3}, {4}, {5})".format(
                             max_n1, max_n2, max_b, n1, n2, B))


def stationary_cov_fwd(leaf, p, A1, A2):
    """Launch the forward kernel: ``K`` ((B,) N1, N2) on the current
    stream, without synchronisation."""
    if A1.device.type != "cuda":
        raise ValueError("stationary_cov_fwd launches a CUDA kernel; A1 is "
                         "on {0}".format(A1.device))
    batched, B, n1, n2 = _shapes(leaf, p, A1, A2)
    K = torch.empty((B, n1, n2), dtype=A1.dtype, device=A1.device)
    if B * n1 * n2:
        lib = _library(leaf, A1.dtype)
        _check_limits(lib, B, n1, n2)
        pp, a1, a2 = _device_args(leaf, p, A1, A2, B)
        with torch.cuda.device(A1.device):
            stream = torch.cuda.current_stream(A1.device).cuda_stream
            err = lib.sc_fwd_launch(pp.data_ptr(), a1.data_ptr(),
                                    a2.data_ptr(), K.data_ptr(), B, n1, n2,
                                    stream)
        _check_launch(lib, err, "forward")
        stationary_cov_fwd.launches += 1
    return K if batched else K[0]


stationary_cov_fwd.launches = 0


def stationary_cov_bwd(leaf, p, A1, A2, g):
    """Launch the backward kernels: ``(dp, dA1, dA2)`` shaped like
    ``(p, A1, A2)``, on the current stream, without synchronisation."""
    if A1.device.type != "cuda":
        raise ValueError("stationary_cov_bwd launches CUDA kernels; A1 is "
                         "on {0}".format(A1.device))
    batched, B, n1, n2 = _shapes(leaf, p, A1, A2, g)
    dp = torch.zeros((B, max(leaf.nparams, 1)), dtype=A1.dtype,
                     device=A1.device)
    da1 = torch.empty((B, n1, len(leaf.axes)), dtype=A1.dtype,
                      device=A1.device)
    da2 = torch.empty((B, n2, len(leaf.axes)), dtype=A1.dtype,
                      device=A1.device)
    if B * n1 * n2:
        lib = _library(leaf, A1.dtype)
        _check_limits(lib, B, n1, n2)
        pp, a1, a2 = _device_args(leaf, p, A1, A2, B)
        gg = g.reshape(B, n1, n2).contiguous()
        with torch.cuda.device(A1.device):
            words = lib.sc_bwd_workspace_words(B, n1, n2)
            if words < 0:
                raise RuntimeError("stationary_cov backward: the device "
                                   "query for its launch plan failed")
            ws = torch.empty(words, dtype=torch.float64, device=A1.device)
            stream = torch.cuda.current_stream(A1.device).cuda_stream
            err = lib.sc_bwd_launch(
                pp.data_ptr(), a1.data_ptr(), a2.data_ptr(), gg.data_ptr(),
                dp.data_ptr(), da1.data_ptr(), da2.data_ptr(), ws.data_ptr(),
                B, n1, n2, stream)
        _check_launch(lib, err, "backward")
        stationary_cov_bwd.launches += 1
    else:
        da1.zero_()
        da2.zero_()
    dp = dp[:, :leaf.nparams]
    if not batched:
        return dp[0], da1[0], da2[0]
    return dp, da1, da2


stationary_cov_bwd.launches = 0


def bwd_grid_launches(leaf, dtype, B, n1, n2):
    """Grid launches of one :func:`stationary_cov_bwd` call at ``(B, N1,
    N2)``, as the kernel library counts them (builds it at first use)."""
    return _library(leaf, dtype).sc_bwd_grid_launches(B, n1, n2)


def bwd_plan(leaf, dtype, B, n1, n2, device=None):
    """``(bands, strips a band, column tiles, resident blocks)`` of the
    backward kernel at ``(B, N1, N2)`` on ``device``'s card."""
    lib = _library(leaf, dtype)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        lib.sc_bwd_plan(B, n1, n2, out)
    return tuple(out)


# -- the plain versions ----------------------------------------------------

def _pairwise_r2(A1, A2):
    """``r2[..., i, j] = sum_d (a1_id - a2_jd)^2`` from exact differences."""
    d = A1[..., :, None, :] - A2[..., None, :, :]
    return torch.sum(d * d, dim=-1)


def _radial_params(p):
    """The parameter vector as the compiled spec functions index it:
    ``p[q]`` is a scalar for an unbatched ``p``, a (B, 1, 1) column for a
    batched one."""
    return p.movedim(-1, 0)[..., None, None] if p.dim() == 2 else p


@lru_cache(maxsize=None)
def _spec_fns(name, constants):
    """The spec's closed forms: ``(slope dk/dr2, [dk/dp_q for each
    parameter])`` as ``f(p, r2)``."""
    spec = available_kernels()[name]
    consts = dict(constants)
    missing = [n for n in ("r2",) + tuple(spec.params)
               if n not in spec.grad_dict]
    if missing:
        raise ValueError("spec {0} has no grad: entry for {1}".format(
            name, missing))
    slope = compiler._compile_scalar_fn(spec, consts, ("r2",),
                                        spec.grad_dict["r2"])
    grads = [compiler._compile_scalar_fn(spec, consts, ("r2",),
                                         spec.grad_dict[n])
             for n in spec.params]
    return slope, grads


def stationary_cov_torch(leaf, p, A1, A2):
    """The plain PyTorch version of :func:`stationary_cov_fwd` (any
    device)."""
    _shapes(leaf, p, A1, A2)
    radial = compiler._radial_fn(leaf.name, leaf.constants)
    return radial(_radial_params(p), _pairwise_r2(A1, A2))


def stationary_cov_vjp_torch(leaf, p, A1, A2, g):
    """The plain PyTorch version of :func:`stationary_cov_bwd`, in closed
    form from the spec's ``grad:`` entries (any device)."""
    _shapes(leaf, p, A1, A2, g)
    slope, grads = _spec_fns(leaf.name, leaf.constants)
    pr = _radial_params(p)
    r2 = _pairwise_r2(A1, A2)
    W = g * slope(pr, r2)
    if grads:
        dp = torch.stack([torch.sum(g * gq(pr, r2), dim=(-2, -1))
                          for gq in grads], dim=-1)
    else:
        dp = torch.zeros_like(p)
    da1 = 2.0 * (torch.sum(W, dim=-1)[..., None] * A1 - W @ A2)
    da2 = 2.0 * (torch.sum(W, dim=-2)[..., None] * A2
                 - W.transpose(-2, -1) @ A1)
    return dp, da1, da2


def stationary_cov_vjp_tiles_torch(leaf, p, A1, A2, g, strips=1):
    """:func:`stationary_cov_vjp_torch` computed the way the backward
    kernel computes it (any device): g cut into tiles of :data:`BAND` rows
    by 512 bytes of columns, each row band's tiles walked in ``strips``
    strips (at most one a tile); per entry ``W delta`` with ``delta = a1_i
    - a2_j`` (so ``dA1 = 2 sum_j W delta``, ``dA2 = -2 sum_i W delta``);
    each tile's row, column and dp sums in the working type, row and dp
    sums carried across a strip's tiles in float64, one column partial per
    (band, column) in the working type, and the finalize summing the
    strips' and the bands' partials in order in float64."""
    batched, B, n1, n2 = _shapes(leaf, p, A1, A2, g)
    dt, dev, f64 = A1.dtype, A1.device, torch.float64
    slope, grads = _spec_fns(leaf.name, leaf.constants)
    d, tc = len(leaf.axes), 512 // A1.element_size()
    bands, ct = -(-n1 // BAND), -(-n2 // tc)
    pr = _radial_params(p)
    a1 = A1.reshape(B, n1, d)
    a2 = A2.reshape(B, n2, d)
    delta = a1[:, :, None, :] - a2[:, None, :, :]
    r2 = torch.sum(delta * delta, dim=-1).reshape(g.shape)
    wd = (g * slope(pr, r2)).reshape(B, n1, n2)[..., None] * delta
    terms = [wd] + [(g * gq(pr, r2)).reshape(B, n1, n2, 1) for gq in grads]
    # Zero padding to whole tiles: (B, bands, BAND, ct, tc, d + NP).
    x = torch.zeros((B, bands * BAND, ct * tc, d + len(grads)), dtype=dt,
                    device=dev)
    x[:, :n1, :n2] = torch.cat(terms, dim=-1)
    x = x.reshape(B, bands, BAND, ct, tc, -1)
    row_t = torch.sum(x[..., :d], dim=4).to(f64)      # (B, bands, BAND, ct, d)
    col_t = torch.sum(x[..., :d], dim=2)              # (B, bands, ct, tc, d)
    dp_t = torch.sum(x[..., d:], dim=(2, 4)).to(f64)  # (B, bands, ct, NP)
    strips = min(strips, ct)                          # as the launcher does
    bounds = [s * ct // strips for s in range(strips + 1)]
    rows = torch.zeros_like(row_t[:, :, :, 0])
    dacc = torch.zeros((B, bands, strips, len(grads)), dtype=f64, device=dev)
    for s in range(strips):
        racc = torch.zeros_like(rows)
        for t in range(bounds[s], bounds[s + 1]):
            racc += row_t[:, :, :, t]
            dacc[:, :, s] += dp_t[:, :, t]
        rows += racc
    dps = torch.zeros((B, len(grads)), dtype=f64, device=dev)
    for blk in dacc.reshape(B, bands * strips, -1).unbind(1):
        dps += blk
    cols = torch.zeros_like(col_t[:, 0], dtype=f64)
    for band in range(bands):
        cols += col_t[:, band].to(f64)
    da1 = (2.0 * rows.reshape(B, bands * BAND, d)[:, :n1]).to(dt)
    da2 = (-2.0 * cols.reshape(B, ct * tc, d)[:, :n2]).to(dt)
    dp = dps.to(dt).reshape(p.shape) if grads else torch.zeros_like(p)
    if not batched:
        return dp, da1[0], da2[0]
    return dp, da1, da2


# -- dispatch and the autograd Function ---------------------------------------

def stationary_cov(leaf, p, A1, A2):
    """K by the kernel for CUDA tensors, by the plain version for CPU
    tensors."""
    if A1.device.type == "cuda":
        return stationary_cov_fwd(leaf, p, A1, A2)
    if A1.device.type == "cpu":
        return stationary_cov_torch(leaf, p, A1, A2)
    raise ValueError("no covariance build for device {0}".format(A1.device))


def stationary_cov_vjp(leaf, p, A1, A2, g):
    """``(dp, dA1, dA2)`` by the kernels for CUDA tensors, by the plain
    version for CPU tensors."""
    if A1.device.type == "cuda":
        return stationary_cov_bwd(leaf, p, A1, A2, g)
    if A1.device.type == "cpu":
        return stationary_cov_vjp_torch(leaf, p, A1, A2, g)
    raise ValueError("no covariance VJP for device {0}".format(A1.device))


@lru_cache(maxsize=None)
def make_stationary_cov(leaf):
    """The differentiable build ``f.apply(p, A1, A2) -> K`` for one
    stationary leaf (a ``torch.autograd.Function`` subclass).

    Under ``torch.func.vmap`` its ``vmap`` rule moves the batch to the front
    of every input (expanding the unbatched ones) and calls the batched
    kernel once; the backward then receives the batched cotangent."""

    class StationaryCov(torch.autograd.Function):

        @staticmethod
        def forward(p, A1, A2):
            return stationary_cov(leaf, p, A1, A2)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(*inputs)

        @staticmethod
        def backward(ctx, g):
            p, A1, A2 = ctx.saved_tensors
            return stationary_cov_vjp(leaf, p, A1, A2, g)

        @staticmethod
        def vmap(info, in_dims, p, A1, A2):
            size = info.batch_size
            args = []
            for x, dim in zip((p, A1, A2), in_dims):
                x = x.expand((size,) + tuple(x.shape)) if dim is None \
                    else x.movedim(dim, 0)
                args.append(x)
            if args[1].dim() != 3:
                raise ValueError("the covariance build takes one batch "
                                 "dimension; got A1 of shape {0}".format(
                                     tuple(args[1].shape)))
            return StationaryCov.apply(*args), 0

    StationaryCov.__name__ = "StationaryCov_{0}".format(leaf.name)
    return StationaryCov
