# -*- coding: utf-8 -*-
"""Blocked batched dense-GP value+gradient for N up to 512, every metric.

Counterpart of the JAX package's ``ops/dense_mxu.py`` (its "MXU" engine).
The fused kernel of :mod:`.dense` takes N <= 256 and metric types 0/1;
this engine lays the chains on the batch axis with per-chain (N, N)
matrices and restructures the factorization so that everything O(N^3)
is a batched 128 x 128 matrix product:

  * the covariance K (B, N, N) is one batched PyTorch build under
    autograd: the theta-independent pairwise boards (squared differences,
    per axis, or the cross products of the general metric) are made once
    per engine, and each chain's K is scalars times boards plus the
    radial function (:func:`_board_builder`);
  * blocked right-looking Cholesky over 128-wide panels: the Schur
    downdates ``S_ij -= L_ik L_jk^T`` and the panel solves
    ``L_ij = S_ij T_jj^T`` are batched ``torch.matmul`` (cuBLAS);
  * the 128 x 128 diagonal blocks go through :func:`spine` — the
    hand-written CUDA kernel ``csrc/dense_spine.cu`` (Cholesky, inverse
    T = L^-1 and log-determinant of every chain's block), or its plain
    version :func:`spine_torch` for tensors on the CPU;
  * T = L^-1 assembled blockwise (``T_ij = -T_ii sum_k L_ik T_kj``), the
    explicit inverse ``W = K^-1 = T^T T``, and ``z = T r``,
    ``quad = |z|^2``, ``alpha = T^T z``;
  * the gradient ``d ll / d theta = 0.5 tr[(alpha alpha^T - W) dK]`` as one
    reverse pass through the build with the cotangent
    ``0.5 (alpha alpha^T - W)``; the mean's is ``sum(alpha)``.  The
    factorization never enters the autograd graph.

Semantics match ``samplers.build_gp_log_prob(method="dense")``:
``ll = -0.5 (N log 2pi + logdet + r^T K^-1 r)`` with
``K = k(theta; X, X) + diag(yerr2 + exp(wn))``; a failed factorization is
NaN (mapped to -inf by the caller).  N is padded to a multiple of 128
with the identity (pivots 1; logdet and alpha untouched).

Deliberate differences from the JAX engine:

  * float32 and float64 both run (the JAX engine cast to float32, the
    TPU's limit);
  * every matrix product runs in full FP32 (or FP64): the engine scopes
    ``torch.backends.cuda.matmul`` to IEEE precision for its call,
    whatever the caller allowed (the JAX engine asked for
    ``Precision.HIGHEST``, f32-exact on the TPU);
  * the layout is chain-major throughout, and the chain count is not
    padded: the TPU's lanes layout, its seam moves and its 128-chain
    padding answer the TPU's vector unit.
"""

import contextlib
import ctypes
import math

import numpy as np
import torch

from .. import _build
from ..dsl import compiler
from ..dsl.compiler import Op

__all__ = ["PANEL", "MXU_MAX_N", "supports_dense_mxu", "spine", "spine_torch",
           "DenseMXUVG", "make_dense_mxu_vg"]

# The diagonal block width (the spine kernel's block).
PANEL = 128
# The largest N the engine takes (the JAX package's dense_mxu.MXU_MAX_N).
MXU_MAX_N = 512

SOURCE = "dense_spine.cu"
_CTYPE = {torch.float32: "float", torch.float64: "double"}
_LOG_2PI = math.log(2.0 * math.pi)


def supports_dense_mxu(node, n):
    """Any kernel tree works here (the build is plain batched PyTorch, so
    all three metric types do); only N is bounded."""
    return n <= MXU_MAX_N


def _round_up(n, m):
    return -(-n // m) * m


@contextlib.contextmanager
def _ieee_matmul():
    """Full-precision float32 matrix products for the block, whatever the
    caller allowed; the caller's setting is restored on exit.  The legacy
    switch sets PyTorch's legacy and new precision states together; the
    new one alone is used only where the caller's states already differ
    (then the legacy getter raises)."""
    m = torch.backends.cuda.matmul
    try:
        saved, attr, full = m.allow_tf32, "allow_tf32", False
    except RuntimeError:
        saved, attr, full = m.fp32_precision, "fp32_precision", "ieee"
    setattr(m, attr, full)
    try:
        yield
    finally:
        setattr(m, attr, saved)


# ---------------------------------------------------------------------------
# The spine: Cholesky, inverse and log-determinant of (B, 128, 128) blocks.
# ---------------------------------------------------------------------------

def spine_instance(dtype):
    """The kernel instantiation for ``dtype`` (:class:`_build.Instance`)."""
    return _build.Instance(SOURCE, {"SP_T": _CTYPE[dtype]})


def _library(dtype):
    lib = _build.load(spine_instance(dtype))
    if not getattr(lib, "_sp_checked", False):
        lib.dense_spine_launch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_void_p]
        lib.dense_spine_launch.restype = ctypes.c_int
        lib.dense_spine_error_string.argtypes = [ctypes.c_int]
        lib.dense_spine_error_string.restype = ctypes.c_char_p
        lib.dense_spine_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.dense_spine_config.restype = None
        cfg = (ctypes.c_int * 5)()
        lib.dense_spine_config(cfg)
        want = (PANEL, torch.empty((), dtype=dtype).element_size())
        if tuple(cfg)[:2] != want:
            raise RuntimeError("dense_spine library {0} does not match {1}"
                               .format(tuple(cfg)[:2], want))
        lib._sp_checked = True
    return lib


def _check_blocks(S):
    if S.dtype not in _CTYPE:
        raise TypeError("S must be float32 or float64, got {0}".format(
            S.dtype))
    if S.dim() != 3 or S.shape[1:] != (PANEL, PANEL):
        raise ValueError("S must be (B, {0}, {0}), got {1}".format(
            PANEL, tuple(S.shape)))


def spine_torch(S):
    """The plain PyTorch version of :func:`spine`: ``cholesky_ex``, a
    triangular solve against the identity and ``2 sum log diag L``; T and
    logdet are NaN wherever the factorization fails."""
    _check_blocks(S)
    L, info = torch.linalg.cholesky_ex(S)
    eye = torch.eye(PANEL, dtype=S.dtype, device=S.device)
    T = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=1, dim2=2)),
                             dim=1)
    bad = info != 0
    nan = torch.full_like(logdet, float("nan"))
    return (torch.where(bad[:, None, None], nan[:, None, None], T),
            torch.where(bad, nan, logdet))


def spine(S):
    """``(T (B, 128, 128), logdet (B,))`` of SPD blocks ``S``: T = L^-1 of
    ``L = chol(S)`` (lower, zeros above), logdet = log det S; NaN in both
    for a chain whose factorization fails.

    A CUDA tensor (contiguous, 16-byte aligned, float32 or float64)
    launches the kernel (``csrc/dense_spine.cu`` over the tiled Cholesky and
    inverse of ``csrc/tile_chol.cuh``) on
    the current stream, without synchronisation; a CPU tensor takes
    :func:`spine_torch`.
    """
    _check_blocks(S)
    if S.device.type == "cpu":
        return spine_torch(S)
    if S.device.type != "cuda":
        raise ValueError("no spine for device {0}".format(S.device))
    if not S.is_contiguous():
        raise ValueError("S must be contiguous")
    if S.data_ptr() % 16:
        raise ValueError("S must be 16-byte aligned (the kernel copies "
                         "16-byte pieces)")
    B = S.shape[0]
    T = torch.empty_like(S)
    logdet = torch.empty(B, dtype=S.dtype, device=S.device)
    if B == 0:
        return T, logdet
    lib = _library(S.dtype)
    with torch.cuda.device(S.device):
        stream = torch.cuda.current_stream(S.device).cuda_stream
        err = lib.dense_spine_launch(S.data_ptr(), T.data_ptr(),
                                     logdet.data_ptr(), B, stream)
    if err != 0:
        raise RuntimeError("dense_spine launch failed: {0}".format(
            lib.dense_spine_error_string(err).decode()))
    spine.launches += 1
    return T, logdet


spine.launches = 0


# ---------------------------------------------------------------------------
# The board builder: the coordinate differences are theta-independent, so
# the pairwise boards are made once and each chain's build is scalars times
# boards plus the elementwise radial function, batched over chains.
# ---------------------------------------------------------------------------

def _params(th):
    """(B, P) -> (P, B, 1, 1): the DSL's ``params[i]`` becomes a per-chain
    scalar broadcast over an (N, N) board."""
    return th.t()[..., None, None]


def _board_builder(node, x_pad, device, dtype):
    """``f(theta_leaf (B, P)) -> (B, N, N)`` with the boards baked in."""
    def board(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device) \
            .to(dtype)

    if isinstance(node, Op):
        f1 = _board_builder(node.k1, x_pad, device, dtype)
        f2 = _board_builder(node.k2, x_pad, device, dtype)
        n1 = compiler.node_size(node.k1)
        if node.op == "sum":
            return lambda th: f1(th[:, :n1]) + f2(th[:, n1:])
        return lambda th: f1(th[:, :n1]) * f2(th[:, n1:])

    axes = list(node.axes)
    A = x_pad[:, axes]                                   # (N, naxes)
    naxes = len(axes)
    n = x_pad.shape[0]

    mask_board = None
    if node.blocked:
        m = np.ones(n, dtype=bool)
        for axis, lo, hi in zip(node.axes, node.min_block, node.max_block):
            col = x_pad[:, axis]
            m = m & (col >= lo) & (col <= hi)
        mask_board = board((m[:, None] & m[None, :]).astype(np.float64))

    def masked(K):
        return K * mask_board if mask_board is not None else K

    if node.stationary:
        radial = compiler._radial_fn(node.name, node.constants)
        mtype = node.metric_type
        diffs = [A[:, i][:, None] - A[:, i][None, :] for i in range(naxes)]
        if mtype == 0:
            d2_sum = board(sum(d * d for d in diffs))
        elif mtype == 1:
            d2 = [board(d * d) for d in diffs]
        else:
            cross = [[board(diffs[a] * diffs[b]) for b in range(naxes)]
                     for a in range(naxes)]

        def value(th):
            p, mp = th[:, :node.nparams], th[:, node.nparams:]
            if mtype == 0:
                r2 = d2_sum * torch.exp(-mp[:, 0])[:, None, None]
            elif mtype == 1:
                r2 = sum(torch.exp(-mp[:, a])[:, None, None] * d2[a]
                         for a in range(naxes))
            else:
                L = torch.func.vmap(
                    lambda m: compiler._unpack_cholesky(m, naxes))(mp)
                eye = torch.eye(naxes, dtype=L.dtype, device=L.device)
                Linv = torch.linalg.solve_triangular(L, eye.expand_as(L),
                                                     upper=False)
                Minv = Linv.transpose(1, 2) @ Linv      # (B, naxes, naxes)
                r2 = sum(Minv[:, a, b][:, None, None] * cross[a][b]
                         for a in range(naxes) for b in range(naxes))
            return masked(radial(_params(p), r2))

        return value

    pair = compiler._pair_fn(node.name, node.constants)
    cols = [board(A[:, i]) for i in range(naxes)]

    def value(th):
        pt = _params(th)
        total = 0.0
        for c in cols:
            total = total + pair(pt, c[:, None], c[None, :])
        out = torch.broadcast_to(total, (th.shape[0], n, n))
        return masked(out)

    return value


# ---------------------------------------------------------------------------
# The batched value+gradient.
# ---------------------------------------------------------------------------

class DenseMXUVG(object):
    """``vg(theta_full (B, D_full)) -> (ll (B,), grad (B, n_active))`` with
    the dataset baked in; the boards and data are made once per device and
    dtype.  Parameter layout of ``theta_full``: [mean (n_mean) | log white
    noise (n_wn) | kernel parameters]; ``active`` lists the full-vector
    indices that get gradients."""

    def __init__(self, node, x, y, yerr2, n_mean, n_wn, active):
        x = np.atleast_2d(np.asarray(x, np.float64))
        self.node = node
        self.n_real = x.shape[0]
        self.n_pad = _round_up(max(self.n_real, PANEL), PANEL)
        if self.n_pad > MXU_MAX_N:
            raise ValueError("the blocked dense engine takes N <= {0}, got "
                             "{1}".format(MXU_MAX_N, self.n_real))
        self.panels = self.n_pad // PANEL
        self.n_mean, self.n_wn = int(n_mean), int(n_wn)
        self.d_full = self.n_mean + self.n_wn + compiler.node_size(node)
        self.active = tuple(int(a) for a in active)
        if any(not 0 <= a < self.d_full for a in self.active):
            raise ValueError("active indices {0} out of range for {1} "
                             "parameters".format(self.active, self.d_full))
        pad = self.n_pad - self.n_real
        self._x_pad = np.concatenate([x, np.zeros((pad, x.shape[1]))])
        idx = np.arange(self.n_pad)
        inb = (idx[:, None] < self.n_real) & (idx[None, :] < self.n_real)
        self._host = dict(
            y=np.pad(np.asarray(y, np.float64), (0, pad)),
            v=np.pad(np.broadcast_to(np.asarray(yerr2, np.float64),
                                     (self.n_real,)), (0, pad)),
            inb=inb.astype(np.float64),
            pad_eye=np.eye(self.n_pad) * (1.0 - inb),
            rmask=(idx < self.n_real).astype(np.float64),
        )
        self._dev = {}

    def data(self, like):
        """The boards and padded data on ``like``'s device, in its dtype."""
        key = (like.device, like.dtype)
        if key not in self._dev:
            d = {k: torch.as_tensor(v, device=like.device).to(like.dtype)
                 for k, v in self._host.items()}
            d["board"] = _board_builder(self.node, self._x_pad, like.device,
                                        like.dtype)
            self._dev[key] = d
        return self._dev[key]

    def build(self, th_k, wn, d):
        """The per-chain padded covariance (B, Np, Np), differentiable in
        ``th_k`` (B, P) and ``wn`` (B,) or None."""
        K = d["board"](th_k)
        noise = d["v"] + torch.exp(wn)[:, None] if wn is not None \
            else d["v"].expand(th_k.shape[0], -1)
        K = K + torch.diag_embed(noise)
        if self.n_pad != self.n_real:
            K = K * d["inb"] + d["pad_eye"]
        return K

    def __call__(self, theta_full):
        if theta_full.device.type not in ("cuda", "cpu"):
            raise ValueError("no dense engine for device {0}".format(
                theta_full.device))
        return self.value_and_grad(theta_full)

    def value_and_grad(self, theta_full, spine_fn=spine, stage=None):
        """The engine with its spine given: :func:`spine` (the kernel on
        the card, the plain version on the CPU) or :func:`spine_torch`.
        ``stage(name)``, if given, is called after each of "build",
        "factor", "inverse", "ll" and "grad"."""
        if theta_full.dtype not in _CTYPE:
            raise TypeError("theta must be float32 or float64, got "
                            "{0}".format(theta_full.dtype))
        if theta_full.dim() != 2 or theta_full.shape[1] != self.d_full:
            raise ValueError("theta must be (B, {0}), got {1}".format(
                self.d_full, tuple(theta_full.shape)))
        mark = stage or (lambda name: None)
        with _ieee_matmul():
            return self._value_and_grad(theta_full.detach(), spine_fn, mark)

    def _value_and_grad(self, theta, spine_fn, mark):
        d = self.data(theta)
        P, npn = PANEL, self.panels
        n_mean, n_wn = self.n_mean, self.n_wn
        n_scalar = n_mean + n_wn
        with torch.enable_grad():
            th_k = theta[:, n_scalar:].clone().requires_grad_(True)
            wn = theta[:, n_mean].clone().requires_grad_(True) if n_wn \
                else None
            K = self.build(th_k, wn, d)
        mark("build")

        Kd = K.detach()

        def blk(i, j):
            return Kd[:, i * P:(i + 1) * P, j * P:(j + 1) * P]

        # Blocked right-looking Cholesky; the diagonal blocks' factors are
        # kept as their inverses T_jj.
        Lb, Tb = {}, {}
        logdet = None
        for j in range(npn):
            S = blk(j, j)
            for k in range(j):
                S = S - Lb[j, k] @ Lb[j, k].transpose(1, 2)
            Tb[j, j], ld = spine_fn(S.contiguous())
            logdet = ld if logdet is None else logdet + ld
            for i in range(j + 1, npn):
                S = blk(i, j)
                for k in range(j):
                    S = S - Lb[i, k] @ Lb[j, k].transpose(1, 2)
                Lb[i, j] = S @ Tb[j, j].transpose(1, 2)
        mark("factor")

        # Off-diagonal blocks of T = L^-1: T_ij = -T_ii sum_k L_ik T_kj.
        for j in range(npn):
            for i in range(j + 1, npn):
                acc = Lb[i, j] @ Tb[j, j]
                for k in range(j + 1, i):
                    acc = acc + Lb[i, k] @ Tb[k, j]
                Tb[i, j] = -(Tb[i, i] @ acc)
        del Lb
        # W = K^-1 = T^T T: W_ab = sum_{k >= max(a, b)} T_ka^T T_kb.
        W = torch.empty_like(Kd)
        for a in range(npn):
            for b in range(a, npn):
                acc = None
                for k in range(b, npn):
                    term = Tb[k, a].transpose(1, 2) @ Tb[k, b]
                    acc = term if acc is None else acc + term
                W[:, a * P:(a + 1) * P, b * P:(b + 1) * P] = acc
                if b != a:
                    W[:, b * P:(b + 1) * P, a * P:(a + 1) * P] = \
                        acc.transpose(1, 2)
        mark("inverse")

        # z = T r, quad = |z|^2, alpha = T^T z.
        r = d["y"] - theta[:, :1] if n_mean else d["y"].expand(
            theta.shape[0], -1)
        r = r * d["rmask"]
        rb = [r[:, a * P:(a + 1) * P, None] for a in range(npn)]
        zb = [sum(Tb[k, a] @ rb[a] for a in range(k + 1))
              for k in range(npn)]
        alpha = torch.cat([
            sum(Tb[k, a].transpose(1, 2) @ zb[k] for k in range(a, npn))
            for a in range(npn)], dim=1)[..., 0]
        quad = sum(torch.sum(z[..., 0] * z[..., 0], dim=1) for z in zb)
        ll = -0.5 * (self.n_real * _LOG_2PI + logdet + quad)
        del Tb, zb
        mark("ll")

        # The gradient: one reverse pass through the build with the
        # cotangent 0.5 (alpha alpha^T - W), formed in W's memory.
        cot = W.mul_(-0.5).addcmul_(alpha[:, :, None], alpha[:, None, :],
                                    value=0.5)
        inputs = [th_k] + ([wn] if n_wn else [])
        if any(a >= n_mean for a in self.active):
            grads = torch.autograd.grad(K, inputs, grad_outputs=cot,
                                        allow_unused=True)
        else:
            grads = [None] * len(inputs)
        del K, cot, W
        g_k = grads[0] if grads[0] is not None else torch.zeros_like(th_k)
        cols = []
        for a in self.active:
            if a < n_mean:
                cols.append(torch.sum(alpha, dim=1))
            elif n_wn and a == n_mean:
                cols.append(grads[1] if grads[1] is not None
                            else torch.zeros_like(ll))
            else:
                cols.append(g_k[:, a - n_scalar])
        grad = torch.stack(cols, dim=1) if cols \
            else theta.new_zeros(theta.shape[0], 0)
        mark("grad")
        return ll.detach(), grad.detach()


def make_dense_mxu_vg(node, x, y, yerr2, n_mean, n_wn, active):
    """Build ``vg(theta_full_b) -> (ll (B,), grad (B, n_active))``.

    :param node: kernel spec tree (any; ``supports_dense_mxu`` must hold).
    :param x: (N, d) coordinates (host array, baked in).
    :param y: observations with any parameter-free mean already subtracted.
    :param yerr2: per-point noise variances with any parameter-free
        white-noise model already folded in.
    :param n_mean,n_wn: 1 if the mean / log-white-noise is a per-chain
        scalar parameter (ConstantModel), else 0.
    :param active: tuple of full-vector indices needing gradients.
    """
    return DenseMXUVG(node, x, y, yerr2, n_mean, n_wn, active)
