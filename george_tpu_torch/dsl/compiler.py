# -*- coding: utf-8 -*-
"""Compile kernel DSL specs + kernel expression trees into torch functions.

The YAML bodies compile against a torch namespace into scalar expressions;
stationary kernels evaluate them on a pairwise ``r2`` matrix, non-stationary
kernels broadcast a per-axis function over the (N1, N2) grid.  The static,
hashable expression tree (:class:`Leaf` / :class:`Op`) keys a cache of
compiled evaluators.

Gradient policy: hyperparameter gradients come from ``torch.autograd``.  The
only hand-fed derivative is the radial derivative dk/d(r2) of stationary
kernels, taken from the DSL ``grad: r2`` entry, because autograd through
``sqrt(r2)`` is NaN at r2 = 0 for the Matern and Exp families.

Large stationary builds on the card take the hand-written tiled kernel
(``ops/cov.py``) under ``config.pallas_covariance`` (:func:`use_pallas`):
the metric is applied to the gathered columns outside the kernel, so
autograd carries the metric gradients through the kernel's dA1 and dA2.

The kernels' gradient tensors (:func:`kernel_gradient_fn`,
:func:`kernel_x1_gradient_fn`, :func:`kernel_x2_gradient_fn`) are forward
mode, one pass a parameter or an input axis, over the tree's plain route:
the covariance kernel's ``autograd.Function`` has a VJP and no forward
rule, so the gradient builds never take it.
"""

import importlib
from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple, Union

import torch

from .. import config
from .specs import available_kernels

__all__ = [
    "Leaf", "Op", "node_size", "kernel_value_fn", "kernel_diag_fn",
    "kernel_gradient_fn", "kernel_x1_gradient_fn", "kernel_x2_gradient_fn",
    "pairwise_squared_distance", "metric_r2_matrix", "use_pallas",
]


def _smart_pow(x, p):
    """``pow`` that uses integer exponentiation for static integral powers.

    C's ``pow(-2.0, 2.0)`` is 4.0; a float exponent on a negative base may be
    NaN.  Kernel constants like the polynomial ``order`` are static Python
    floats, so integral ones lower to an integer power.
    """
    if isinstance(p, (int, float)) and not isinstance(p, bool) \
            and float(p) == int(p):
        if not torch.is_tensor(x):
            return float(x) ** int(p)
        return x ** int(p)
    return torch.pow(x, p)


def _maximum(a, b):
    if not torch.is_tensor(b):
        return torch.clamp(a, min=b)
    if not torch.is_tensor(a):
        return torch.clamp(b, min=a)
    return torch.maximum(a, b)


def _minimum(a, b):
    if not torch.is_tensor(b):
        return torch.clamp(a, max=b)
    if not torch.is_tensor(a):
        return torch.clamp(b, max=a)
    return torch.minimum(a, b)


def _where(cond, a, b):
    like = b if torch.is_tensor(b) else a
    if not torch.is_tensor(a):
        a = torch.as_tensor(a, dtype=like.dtype, device=like.device)
    if not torch.is_tensor(b):
        b = torch.as_tensor(b, dtype=like.dtype, device=like.device)
    return torch.where(cond, a, b)


# Names available to DSL expression bodies.
_NAMESPACE = {
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "abs": torch.abs,
    "fabs": torch.abs,
    "pow": _smart_pow,
    "where": _where,
    "maximum": _maximum,
    "minimum": _minimum,
    "erf": torch.special.erf,
    "erfc": torch.special.erfc,
    "M_PI": 3.141592653589793238462643383279502884,
    "DBL_EPSILON": 2.220446049250313e-16,
}


def _compile_scalar_fn(spec, constants, xargs, body):
    """Compile one DSL expression into ``f(param_vector, *xargs)``.

    ``param_vector`` is a 1-D tensor holding the spec's trainable parameters
    in declaration order; reparams are evaluated inline.
    """
    lines = ["def _kernel_fn(__params, {0}):".format(", ".join(xargs))]
    for i, name in enumerate(spec.params):
        lines.append("    {0} = __params[{1}]".format(name, i))
    for name, expr in spec.reparams:
        lines.append("    {0} = ({1})".format(name, expr))
    lines.append("    return ({0})".format(body))
    namespace = dict(_NAMESPACE)
    namespace.update(constants)
    # Extra callables a spec pulls into scope (``imports:``).
    for imp in getattr(spec, "imports", ()):
        module_path, _, attr = imp.partition(":")
        module = importlib.import_module(module_path)
        namespace[attr] = getattr(module, attr)
    exec("\n".join(lines), namespace)
    return namespace["_kernel_fn"]


@lru_cache(maxsize=None)
def _radial_fn(name, constants):
    """Radial function k(params, r2) with the DSL's d/d(r2) as its gradient.

    The value is evaluated at a detached ``r2`` (parameter gradients by
    autograd, smooth everywhere); the r2 gradient enters through a
    zero-valued first-order term carrying the closed-form derivative, which
    is finite at r2 = 0.  The term is added whenever autograd records, not
    only when ``r2.requires_grad`` says so: under ``torch.func.vmap`` that
    flag reads False on the batched ``r2`` even when the metric parameters
    require gradients.
    """
    spec = available_kernels()[name]
    consts = dict(constants)
    value = _compile_scalar_fn(spec, consts, ("r2",), spec.value)
    grad_r2 = _compile_scalar_fn(spec, consts, ("r2",), spec.grad_dict["r2"])

    def radial(p, r2):
        r2_const = r2.detach()
        out = value(p, r2_const)
        if torch.is_grad_enabled():
            slope = grad_r2(p.detach(), r2_const)
            out = out + slope * (r2 - r2_const)
        return out

    return radial


@lru_cache(maxsize=None)
def _pair_fn(name, constants):
    """Per-axis scalar function k(params, a, b) for non-stationary kernels."""
    spec = available_kernels()[name]
    return _compile_scalar_fn(spec, dict(constants), ("x1", "x2"), spec.value)


# ---------------------------------------------------------------------------
# Static expression-tree nodes (hashable cache keys).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Leaf:
    """Static description of one concrete kernel instance."""

    name: str
    constants: Tuple[Tuple[str, float], ...]
    ndim: int
    axes: Tuple[int, ...]
    stationary: bool
    nparams: int
    metric_type: int = -1
    nmetric: int = 0
    blocked: bool = False
    min_block: Tuple[float, ...] = ()
    max_block: Tuple[float, ...] = ()


@dataclass(frozen=True)
class Op:
    """A Sum or Product of two kernel subtrees."""

    op: str  # "sum" | "product"
    k1: Union["Op", Leaf]
    k2: Union["Op", Leaf]


Node = Union[Op, Leaf]


def node_size(node: Node) -> int:
    """Length of the (full) parameter vector a node consumes."""
    if isinstance(node, Op):
        return node_size(node.k1) + node_size(node.k2)
    return node.nparams + node.nmetric


# ---------------------------------------------------------------------------
# Metric r2 computation.
# ---------------------------------------------------------------------------

def pairwise_squared_distance(A, B):
    """All-pairs ``r2[i, j] = sum_k (a_ik - b_jk)^2`` from exact differences
    (exact at coincident points, unlike the |a|^2 + |b|^2 - 2ab identity)."""
    d = A[:, None, :] - B[None, :, :]
    return torch.sum(d * d, dim=-1)


def _unpack_cholesky(mparams, n):
    """Packed row-major lower-triangle params -> dense L (log-diagonal)."""
    i, j = torch.tril_indices(n, n, device=mparams.device)
    L = mparams.new_zeros(n, n).index_put((i, j), mparams)
    d = torch.diagonal(L)
    return L - torch.diag(d) + torch.diag(torch.exp(d))


def _solve_lower(L, A):
    """Rows of ``A`` mapped through ``L^{-1}``: solve(L, A^T)^T."""
    return torch.linalg.solve_triangular(L, A.T, upper=False).T


def metric_r2_matrix(metric_type, naxes, mparams, A1, A2):
    """Pairwise ``r2`` under a metric, on pre-gathered axis columns:
    isotropic (0), axis-aligned (1), general via a Cholesky solve (2)."""
    if metric_type == 0:
        return pairwise_squared_distance(A1, A2) * torch.exp(-mparams[0])
    if metric_type == 1:
        scale = torch.exp(-0.5 * mparams)
        return pairwise_squared_distance(A1 * scale, A2 * scale)
    if metric_type == 2:
        L = _unpack_cholesky(mparams, naxes)
        return pairwise_squared_distance(_solve_lower(L, A1),
                                         _solve_lower(L, A2))
    raise ValueError("unknown metric_type {0}".format(metric_type))


def metric_r2_rows(metric_type, naxes, mparams, A1, A2):
    """Row-wise ``r2`` between aligned points (the "diagonal" evaluation)."""
    d = A1 - A2
    if metric_type == 0:
        return torch.sum(d * d, dim=1) * torch.exp(-mparams[0])
    if metric_type == 1:
        return torch.sum(d * d * torch.exp(-mparams), dim=1)
    if metric_type == 2:
        L = _unpack_cholesky(mparams, naxes)
        y = _solve_lower(L, d)
        return torch.sum(y * y, dim=1)
    raise ValueError("unknown metric_type {0}".format(metric_type))


# ---------------------------------------------------------------------------
# Matrix-level evaluators.
# ---------------------------------------------------------------------------

def _gather_axes(X, axes):
    return X[:, list(axes)]


def _block_mask(X, axes, min_block, max_block):
    """Points inside the per-axis block window."""
    mask = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
    for axis, lo, hi in zip(axes, min_block, max_block):
        col = X[:, axis]
        mask = mask & (col >= lo) & (col <= hi)
    return mask


def use_pallas(leaf, n1, n2, dtype, device):
    """True when the (n1, n2) build of ``leaf`` in ``dtype`` on ``device``
    takes the tiled covariance kernel (``config.pallas_covariance``): never
    a blocked or non-stationary leaf, never off the card; under "auto" only
    float32 builds of at least ``config.pallas_min_elements`` entries."""
    if config.pallas_covariance == "never" or not leaf.stationary \
            or leaf.blocked:
        return False
    if torch.device(device).type != "cuda":
        return False
    if config.pallas_covariance == "always":
        return True
    return n1 * n2 >= config.pallas_min_elements and dtype == torch.float32


@lru_cache(maxsize=None)
def _value_builder(node: Node, plain=False):
    """Build ``f(theta, X1, X2) -> (N1, N2)`` for a kernel tree; with
    ``plain`` no build takes the covariance kernel."""
    if isinstance(node, Op):
        f1 = _value_builder(node.k1, plain)
        f2 = _value_builder(node.k2, plain)
        n1 = node_size(node.k1)
        if node.op == "sum":
            return lambda th, X1, X2: f1(th[:n1], X1, X2) + f2(th[n1:], X1, X2)
        return lambda th, X1, X2: f1(th[:n1], X1, X2) * f2(th[n1:], X1, X2)

    axes = node.axes

    if node.stationary:
        radial = _radial_fn(node.name, node.constants)

        def metric_transform(mp, X):
            """Columns transformed so that r2 = |a1 - a2|^2."""
            A = _gather_axes(X, axes)
            if node.metric_type == 0:
                return A * torch.exp(-0.5 * mp[0])
            if node.metric_type == 1:
                return A * torch.exp(-0.5 * mp)
            return _solve_lower(_unpack_cholesky(mp, len(axes)), A)

        def value(theta, X1, X2):
            p, mp = theta[:node.nparams], theta[node.nparams:]
            if not plain and use_pallas(node, X1.shape[0], X2.shape[0],
                                        X1.dtype, X1.device):
                from ..ops import cov
                return cov.make_stationary_cov(node).apply(
                    p, metric_transform(mp, X1), metric_transform(mp, X2))
            r2 = metric_r2_matrix(
                node.metric_type, len(axes), mp,
                _gather_axes(X1, axes), _gather_axes(X2, axes),
            )
            K = radial(p, r2)
            if node.blocked:
                m1 = _block_mask(X1, axes, node.min_block, node.max_block)
                m2 = _block_mask(X2, axes, node.min_block, node.max_block)
                K = torch.where(m1[:, None] & m2[None, :], K,
                                torch.zeros_like(K))
            return K

        return value

    pair = _pair_fn(node.name, node.constants)

    def value(theta, X1, X2):
        total = X1.new_zeros(())
        for j in axes:
            total = total + pair(theta, X1[:, j][:, None], X2[:, j][None, :])
        return torch.broadcast_to(total, (X1.shape[0], X2.shape[0]))

    return value


@lru_cache(maxsize=None)
def _diag_builder(node: Node):
    """Build ``f(theta, X1, X2) -> (N,)`` evaluating k(x1_i, x2_i) row-wise."""
    if isinstance(node, Op):
        f1 = _diag_builder(node.k1)
        f2 = _diag_builder(node.k2)
        n1 = node_size(node.k1)
        if node.op == "sum":
            return lambda th, X1, X2: (
                f1(th[:n1], X1, X2) + f2(th[n1:], X1, X2)
            )
        return lambda th, X1, X2: f1(th[:n1], X1, X2) * f2(th[n1:], X1, X2)

    axes = node.axes
    if node.stationary:
        radial = _radial_fn(node.name, node.constants)

        def diag(theta, X1, X2):
            p = theta[:node.nparams]
            r2 = metric_r2_rows(
                node.metric_type, len(axes), theta[node.nparams:],
                _gather_axes(X1, axes), _gather_axes(X2, axes),
            )
            out = radial(p, r2)
            if node.blocked:
                m1 = _block_mask(X1, axes, node.min_block, node.max_block)
                m2 = _block_mask(X2, axes, node.min_block, node.max_block)
                out = torch.where(m1 & m2, out, torch.zeros_like(out))
            return out

        return diag

    pair = _pair_fn(node.name, node.constants)

    def diag(theta, X1, X2):
        total = X1.new_zeros(())
        for j in axes:
            total = total + pair(theta, X1[:, j], X2[:, j])
        return torch.broadcast_to(total, (X1.shape[0],))

    return diag


def kernel_value_fn(node: Node):
    """``K(theta, X1, X2)`` covariance builder for a kernel tree."""
    return _value_builder(node)


def kernel_diag_fn(node: Node):
    """Row-wise ``k(x1_i, x2_i)`` evaluator (``value_diagonal``)."""
    return _diag_builder(node)


def _tangents(fn, primal, directions):
    """The forward-mode derivatives of ``fn`` at ``primal`` along each of
    ``directions``, stacked on a last axis."""
    import torch.autograd.forward_ad as fwAD

    out = []
    for direction in directions:
        with fwAD.dual_level():
            value = fn(fwAD.make_dual(primal, direction))
            tangent = fwAD.unpack_dual(value).tangent
        out.append(torch.zeros_like(value) if tangent is None else tangent)
    if not out:                          # no parameters: (N1, N2, 0)
        return fn(primal)[..., None][..., :0]
    return torch.stack(out, dim=-1)


def _unit_columns(X, axis):
    e = torch.zeros_like(X)
    e[:, axis] = 1.0
    return e


def kernel_gradient_fn(node: Node):
    """``g(theta, X1, X2) -> (N1, N2, full_size)``: the hyperparameter
    gradient tensor, forward mode over the parameter vector on the plain
    route."""
    value = _value_builder(node, True)

    def gradient(theta, X1, X2):
        eye = torch.eye(theta.shape[0], dtype=theta.dtype,
                        device=theta.device)
        return _tangents(lambda th: value(th, X1, X2), theta, eye)

    return gradient


def kernel_x1_gradient_fn(node: Node):
    """``g(theta, X1, X2) -> (N1, N2, ndim)``: d k(x1_i, x2_j) / d x1_i,
    forward mode along each input axis on the plain route (row i of K
    depends on row i of X1 alone)."""
    value = _value_builder(node, True)

    def x1_gradient(theta, X1, X2):
        return _tangents(lambda X: value(theta, X, X2), X1,
                         [_unit_columns(X1, k) for k in range(X1.shape[1])])

    return x1_gradient


def kernel_x2_gradient_fn(node: Node):
    """``g(theta, X1, X2) -> (N1, N2, ndim)``: d k(x1_i, x2_j) / d x2_j."""
    value = _value_builder(node, True)

    def x2_gradient(theta, X1, X2):
        return _tangents(lambda X: value(theta, X1, X), X2,
                         [_unit_columns(X2, k) for k in range(X2.shape[1])])

    return x2_gradient
