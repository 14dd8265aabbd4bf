# -*- coding: utf-8 -*-
"""Generate CUDA C++ device code for a kernel expression tree.

george's own design is a YAML DSL from which the kernels' C++ is generated;
this module does that again for the hand-written dense kernel
(``csrc/dense_vg.cu``).  :func:`generate` turns a static kernel tree
(:class:`~george_tpu_torch.dsl.compiler.Leaf` / ``Op``) into a header that
defines, in ``namespace gt::<namespace>``,

    template <typename T, typename S>
    S kernel_value(const S* th, const T* x1, const T* x2);

one entry k(theta; x1, x2) of the covariance, with the same semantics as
:func:`george_tpu_torch.dsl.compiler.kernel_value_fn`: sums and products,
stationary leaves on their axes under an isotropic (0) or axis-aligned (1)
metric, block windows, and non-stationary leaves as per-axis sums of the
spec's pair function.  ``T`` is the scalar type of the inputs, ``S`` that of
the parameters: ``T`` itself for the covariance, ``gt::Dual<T, NA>``
(``csrc/dual.cuh``) for the covariance and its NA parameter tangents.

The spec bodies (``value:`` and ``grad: r2:``) are parsed with :mod:`ast`
and translated node by node; the tree's constants become literals, and
every subexpression of constants alone (``order - 1.0``, the test of
``a if order == 0.0 else b``) is folded here, as the torch compiler folds it
at trace time.  Integral static powers become repeated products (C's
``pow`` of a negative base), as :func:`compiler._smart_pow` makes them.

The radial function of a stationary leaf is evaluated at a primal ``r2``
with the parameters' tangents, and the r2 tangent enters through the spec's
closed-form ``grad: r2`` times ``dr2`` (the torch compiler's custom slope,
``compiler._radial_fn``): the forward-mode tangent of ``sqrt(3 r2)`` at
r2 = 0, on every diagonal entry, would be 0 * inf = NaN.
"""

import ast
import math

from .compiler import Op, node_size
from .specs import available_kernels

__all__ = ["CodegenError", "generate", "generate_radial",
           "primal_ops", "radial_ops"]

_FUNCS = {
    "exp": "exp", "log": "log", "sqrt": "sqrt", "sin": "sin", "cos": "cos",
    "tan": "tan", "sinh": "sinh", "cosh": "cosh", "tanh": "tanh",
    "abs": "fabs", "fabs": "fabs", "erf": "erf", "erfc": "erfc",
}
_GLOBAL_CONSTANTS = {
    "M_PI": 3.141592653589793238462643383279502884,
    "DBL_EPSILON": 2.220446049250313e-16,
}
_BINOPS = {ast.Add: ("+", lambda a, b: a + b),
           ast.Sub: ("-", lambda a, b: a - b),
           ast.Mult: ("*", lambda a, b: a * b),
           ast.Div: ("/", lambda a, b: a / b)}
_CMPOPS = {ast.Lt: ("<", lambda a, b: a < b),
           ast.LtE: ("<=", lambda a, b: a <= b),
           ast.Gt: (">", lambda a, b: a > b),
           ast.GtE: (">=", lambda a, b: a >= b),
           ast.Eq: ("==", lambda a, b: a == b),
           ast.NotEq: ("!=", lambda a, b: a != b)}


class CodegenError(ValueError):
    """A spec expression this translator has no C++ form for."""


def literal(value):
    """A float as a literal of the scalar type ``T``."""
    value = float(value)
    if math.isinf(value):
        return "T(INFINITY)" if value > 0 else "T(-INFINITY)"
    if math.isnan(value):
        raise CodegenError("NaN constant in a kernel expression")
    return "T({0!r})".format(value)


class _Expr(object):
    """A translated expression: C++ text, its constant value (if it folds)
    and its count of primal operations."""

    __slots__ = ("code", "const", "ops")

    def __init__(self, code, const=None, ops=0):
        self.code, self.const, self.ops = code, const, ops


def _const(value):
    return _Expr(literal(value) if not isinstance(value, bool)
                 else ("true" if value else "false"), value, 0)


class _Translator(object):
    """Translate one DSL expression with a name environment: a name maps to
    a float (a constant) or to the C++ text of a variable."""

    def __init__(self, env):
        self.env = env

    def __call__(self, text):
        try:
            tree = ast.parse(text, mode="eval")
        except SyntaxError as exc:
            raise CodegenError("cannot parse {0!r}: {1}".format(text, exc))
        return self.visit(tree.body)

    def visit(self, node):
        method = getattr(self, "visit_" + type(node).__name__, None)
        if method is None:
            raise CodegenError("no C++ form for {0}".format(ast.dump(node)))
        return method(node)

    def visit_Constant(self, node):
        if isinstance(node.value, bool) or \
                not isinstance(node.value, (int, float)):
            raise CodegenError("constant {0!r}".format(node.value))
        return _const(float(node.value))

    def visit_Name(self, node):
        if node.id in self.env:
            v = self.env[node.id]
            return _const(v) if isinstance(v, float) else _Expr(v)
        if node.id in _GLOBAL_CONSTANTS:
            return _const(_GLOBAL_CONSTANTS[node.id])
        raise CodegenError("unknown name {0!r}".format(node.id))

    def visit_UnaryOp(self, node):
        a = self.visit(node.operand)
        if isinstance(node.op, ast.UAdd):
            return a
        if isinstance(node.op, ast.USub):
            if a.const is not None:
                return _const(-a.const)
            return _Expr("(-{0})".format(a.code), None, a.ops + 1)
        if isinstance(node.op, ast.Not) and a.const is not None:
            return _const(not a.const)
        raise CodegenError("unary operator {0}".format(ast.dump(node.op)))

    def visit_BinOp(self, node):
        a, b = self.visit(node.left), self.visit(node.right)
        if isinstance(node.op, ast.Pow):
            return self._pow(a, b)
        if type(node.op) not in _BINOPS:
            raise CodegenError("operator {0}".format(ast.dump(node.op)))
        sym, fn = _BINOPS[type(node.op)]
        if a.const is not None and b.const is not None:
            return _const(fn(a.const, b.const))
        return _Expr("({0} {1} {2})".format(a.code, sym, b.code), None,
                     a.ops + b.ops + 1)

    def _pow(self, a, b):
        if a.const is not None and b.const is not None:
            return _const(float(a.const) ** float(b.const))
        if b.const is not None and float(b.const) == int(b.const):
            k = int(b.const)
            return _Expr("ipow<{0}>({1})".format(k, a.code), None,
                         a.ops + max(abs(k) - 1, 0) + (k < 0))
        return _Expr("pow({0}, {1})".format(a.code, b.code), None,
                     a.ops + b.ops + 1)

    def visit_Compare(self, node):
        if len(node.ops) != 1:
            raise CodegenError("chained comparison")
        a, b = self.visit(node.left), self.visit(node.comparators[0])
        sym, fn = _CMPOPS[type(node.ops[0])]
        if a.const is not None and b.const is not None:
            return _const(bool(fn(a.const, b.const)))
        return _Expr("(value_of({0}) {1} value_of({2}))".format(
            a.code, sym, b.code), None, a.ops + b.ops + 1)

    def visit_BoolOp(self, node):
        vals = [self.visit(v) for v in node.values]
        if all(v.const is not None for v in vals):
            fold = all if isinstance(node.op, ast.And) else any
            return _const(bool(fold(v.const for v in vals)))
        sym = " && " if isinstance(node.op, ast.And) else " || "
        return _Expr("(" + sym.join(v.code for v in vals) + ")", None,
                     sum(v.ops for v in vals) + len(vals) - 1)

    def visit_IfExp(self, node):
        test = self.visit(node.test)
        if test.const is None:
            raise CodegenError("a conditional expression must test "
                               "constants only; use where() otherwise")
        return self.visit(node.body if test.const else node.orelse)

    def visit_Call(self, node):
        if not isinstance(node.func, ast.Name) or node.keywords:
            raise CodegenError("call {0}".format(ast.dump(node)))
        name = node.func.id
        args = [self.visit(a) for a in node.args]
        consts = [a.const for a in args]
        if name == "pow" and len(args) == 2:
            return self._pow(*args)
        if name == "where" and len(args) == 3:
            if consts[0] is not None:
                return args[1] if consts[0] else args[2]
            return _Expr("where({0}, {1}, {2})".format(
                *(a.code for a in args)), None, sum(a.ops for a in args) + 1)
        if name in ("maximum", "minimum") and len(args) == 2:
            if None not in consts:
                return _const((max if name == "maximum" else min)(*consts))
            return _Expr("{0}({1}, {2})".format(name, args[0].code,
                                                 args[1].code), None,
                         args[0].ops + args[1].ops + 1)
        if name in _FUNCS and len(args) == 1:
            if consts[0] is not None and hasattr(math, name):
                return _const(getattr(math, name)(consts[0]))
            return _Expr("{0}({1})".format(_FUNCS[name], args[0].code), None,
                         args[0].ops + 1)
        raise CodegenError("function {0}/{1}".format(name, len(args)))


def _leaves(node):
    if isinstance(node, Op):
        return _leaves(node.k1) + _leaves(node.k2)
    return [node]


def _spec(leaf):
    spec = available_kernels().get(leaf.name)
    if spec is None:
        raise CodegenError("no spec for {0}".format(leaf.name))
    if spec.imports:
        raise CodegenError("spec {0} imports Python callables ({1}), which "
                           "have no C++ form".format(spec.name, spec.imports))
    return spec


def _param_env(spec, leaf, prefix):
    """Names of a leaf's parameters and constants."""
    env = {name: float(v) for name, v in leaf.constants}
    for name in spec.params:
        env[name] = "{0}_{1}".format(prefix, name)
    return env


def _reparam_lines(spec, env, prefix, ctype="const auto"):
    """Declare the spec's reparameterisations in ``env``'s names (in the
    spec's order, which is the torch compiler's)."""
    lines, ops = [], 0
    for name, expr in spec.reparams:
        e = _Translator(env)(expr)
        var = "{0}_{1}".format(prefix, name)
        if e.const is not None:
            env[name] = float(e.const)
            continue
        lines.append("  {0} {1} = {2};".format(ctype, var, e.code))
        env[name] = var
        ops += e.ops
    return lines, ops


def _radial_value(spec, leaf, param):
    """Declarations and expression of the radial value at ``r2v`` (type
    ``T``), the parameters of type ``S`` read as ``param(i)``."""
    env = _param_env(spec, leaf, "p")
    lines = ["  const S& p_{0} = {1};".format(name, param(i))
             for i, name in enumerate(spec.params)]
    rlines, ops = _reparam_lines(spec, env, "r")
    env["r2"] = "r2v"
    value = _Translator(env)(spec.value)
    return lines + rlines, value, ops + value.ops


def _radial_slope(spec, leaf, param):
    """Declarations and expression of the closed-form slope ``grad: r2`` at
    ``r2v``, the primal parameters (type ``T``) read as ``param(i)``."""
    if "r2" not in spec.grad_dict:
        raise CodegenError("stationary spec {0} has no grad: r2".format(
            spec.name))
    env = _param_env(spec, leaf, "pv")
    lines = ["  const T pv_{0} = {1};".format(name, param(i))
             for i, name in enumerate(spec.params)]
    rlines, ops = _reparam_lines(spec, env, "rv", ctype="const T")
    env["r2"] = "r2v"
    slope = _Translator(env)(spec.grad_dict["r2"])
    return lines + rlines, slope, ops + slope.ops


def _stationary_leaf(leaf, spec, fname):
    if leaf.metric_type not in (0, 1):
        raise CodegenError("metric type {0} (only isotropic 0 and "
                           "axis-aligned 1 are generated)".format(
                               leaf.metric_type))
    np_ = leaf.nparams
    body, ops = [], 0
    if leaf.blocked:
        conds = []
        for a, lo, hi in zip(leaf.axes, leaf.min_block, leaf.max_block):
            for x in ("x1", "x2"):
                conds.append("{0}[{1}] >= {2} && {0}[{1}] <= {3}".format(
                    x, a, literal(lo), literal(hi)))
        body.append("  if (!({0})) return promote<S>(T(0));".format(
            " && ".join(conds)))
        ops += 4 * len(leaf.axes)
    for i, a in enumerate(leaf.axes):
        body.append("  const T d{0} = x1[{1}] - x2[{1}];".format(i, a))
    ops += len(leaf.axes)
    if leaf.metric_type == 0:
        body.append("  const S r2 = ({0}) * exp(-th[{1}]);".format(
            " + ".join("d{0} * d{0}".format(i)
                       for i in range(len(leaf.axes))), np_))
        ops += 2 * len(leaf.axes) + 1
    else:
        body.append("  const S r2 = promote<S>({0});".format(" + ".join(
            "d{0} * d{0} * exp(-th[{1}])".format(i, np_ + i)
            for i in range(len(leaf.axes)))))
        ops += 4 * len(leaf.axes) - 1
    body.append("  const T r2v = value_of(r2);")
    lines, value, vops = _radial_value(spec, leaf, "th[{0}]".format)
    body += lines
    body.append("  S out = promote<S>({0});".format(value.code))
    ops += vops
    # The r2 tangent through the closed-form slope, at the primal
    # parameters.
    glines, slope, _ = _radial_slope(
        spec, leaf, lambda i: "value_of(p_{0})".format(spec.params[i]))
    body.append("  if constexpr (is_dual<S>::value) {")
    body += ["  " + line for line in glines]
    body.append("    const T slope = promote<T>({0});".format(slope.code))
    body.append("    out = out + slope * tangent_of(r2);")
    body.append("  }")
    body.append("  return out;")
    head = "// {0} (stationary, metric type {1}) on axes {2}{3}".format(
        spec.name, leaf.metric_type, tuple(leaf.axes),
        ", block window" if leaf.blocked else "")
    return head, fname, body, ops


def _pair_leaf(leaf, spec, fname):
    body = []
    env = _param_env(spec, leaf, "p")
    for i, name in enumerate(spec.params):
        body.append("  const S& p_{0} = th[{1}];".format(name, i))
    lines, ops = _reparam_lines(spec, env, "r")
    body += lines
    terms = []
    for a in leaf.axes:
        env["x1"] = "x1[{0}]".format(a)
        env["x2"] = "x2[{0}]".format(a)
        e = _Translator(env)(spec.value)
        terms.append("promote<S>({0})".format(e.code))
        ops += e.ops + 1
    body.append("  return {0};".format(" + ".join(terms) if terms
                                          else "promote<S>(T(0))"))
    head = "// {0} (non-stationary) on axes {1}".format(spec.name,
                                                      tuple(leaf.axes))
    return head, fname, body, ops


def _leaf(leaf, fname):
    spec = _spec(leaf)
    if leaf.stationary:
        return _stationary_leaf(leaf, spec, fname)
    return _pair_leaf(leaf, spec, fname)


def _tree_expr(node, names, offset):
    """The C++ expression of a subtree over its leaf functions."""
    if isinstance(node, Op):
        a, ops_a, off = _tree_expr(node.k1, names, offset)
        b, ops_b, off = _tree_expr(node.k2, names, off)
        sym = "+" if node.op == "sum" else "*"
        return "({0} {1} {2})".format(a, sym, b), ops_a + ops_b + 1, off
    fname, ops = names[id(node)]
    return ("{0}<T, S>(th + {1}, x1, x2)".format(fname, offset), ops,
            offset + node.nparams + node.nmetric)


def _build(node, namespace):
    leaves = _leaves(node)
    names, chunks = {}, []
    for k, leaf in enumerate(leaves):
        head, fname, body, ops = _leaf(leaf, "leaf{0}".format(k))
        names[id(leaf)] = (fname, ops)
        chunks.append("{0}\ntemplate <typename T, typename S>\n"
                      "GT_HD S {1}(const S* th, const T* x1, const T* x2) "
                      "{{\n{2}\n}}\n".format(head, fname, "\n".join(body)))
    expr, ops, _ = _tree_expr(node, names, 0)
    ndim = max(leaf.ndim for leaf in leaves)
    text = (
        "// Generated by george_tpu_torch/dsl/cuda_codegen.py from the kernel "
        "specs; do not edit.\n"
        "// Tree: {tree}\n"
        "#pragma once\n"
        "#include \"dual.cuh\"\n\n"
        "#define GT_TREE_NP {np}\n"
        "#define GT_TREE_NDIM {ndim}\n\n"
        "namespace gt {{\nnamespace {ns} {{\n\n"
        "{leaves}\n"
        "// k(theta; x1, x2) for the whole tree; th holds its {np} "
        "parameters.\n"
        "template <typename T, typename S>\n"
        "GT_HD S kernel_value(const S* th, const T* x1, const T* x2) {{\n"
        "  return {expr};\n}}\n\n"
        "}}  // namespace {ns}\n}}  // namespace gt\n"
    ).format(tree=_describe(node), np=node_size(node), ndim=ndim,
             ns=namespace, leaves="\n".join(chunks), expr=expr)
    return text, ops


def _describe(node):
    if isinstance(node, Op):
        return "({0} {1} {2})".format(_describe(node.k1),
                                      "+" if node.op == "sum" else "*",
                                      _describe(node.k2))
    return "{0}{1}".format(node.name, tuple(node.axes))


def generate(node, namespace="tree"):
    """The header text of ``kernel_value`` for ``node`` (see the module
    docstring); raises :class:`CodegenError` for what it cannot express."""
    return _build(node, namespace)[0]


def primal_ops(node):
    """Arithmetic operations (each ``exp`` / ``sqrt`` / ``pow`` one) of one
    primal evaluation of ``kernel_value``, as generated; the operand count
    of the dense kernel's covariance build, per entry."""
    return _build(node, "tree")[1]


def _radial(leaf, namespace):
    if not leaf.stationary:
        raise CodegenError("{0} is not stationary".format(leaf.name))
    spec = _spec(leaf)
    vlines, value, vops = _radial_value(spec, leaf, "p[{0}]".format)
    slines, slope, sops = _radial_slope(spec, leaf, "p[{0}]".format)
    text = (
        "// Generated by george_tpu_torch/dsl/cuda_codegen.py from the kernel "
        "specs; do not edit.\n"
        "// The radial function of {name}{consts}.\n"
        "#pragma once\n"
        "#include \"dual.cuh\"\n\n"
        "#define GT_RADIAL_NP {np}\n\n"
        "namespace gt {{\nnamespace {ns} {{\n\n"
        "// k(p; r2): S is T for the value, Dual<T, NP> for the value and its\n"
        "// tangents in the {np} radial parameters p.\n"
        "template <typename T, typename S>\n"
        "GT_HD S radial_value(const S* p, const T r2v) {{\n"
        "{vlines}  (void)p;\n  return promote<S>({value});\n}}\n\n"
        "// dk/d(r2) at the primal parameters: the spec's grad: r2, guarded\n"
        "// where the slope diverges.\n"
        "template <typename T>\n"
        "GT_HD T radial_slope(const T* p, const T r2v) {{\n"
        "{slines}  (void)p;\n  return promote<T>({slope});\n}}\n\n"
        "}}  // namespace {ns}\n}}  // namespace gt\n"
    ).format(name=spec.name,
             consts="".join(" {0}={1!r}".format(k, v)
                            for k, v in leaf.constants),
             np=leaf.nparams, ns=namespace,
             vlines="".join(line + "\n" for line in vlines),
             value=value.code,
             slines="".join(line + "\n" for line in slines),
             slope=slope.code)
    return text, vops, sops


def generate_radial(leaf, namespace="radial"):
    """The header of a stationary leaf's radial function alone, for the
    tiled covariance kernel (``csrc/stationary_cov.cu``).  It defines, in
    ``namespace gt::<namespace>``, ``GT_RADIAL_NP`` (the leaf's radial
    parameter count, possibly 0) and

        template <typename T, typename S>
        S radial_value(const S* p, T r2);    // k(p; r2), S = T or Dual
        template <typename T>
        T radial_slope(const T* p, T r2);    // the spec's grad: r2

    from the spec's ``value:`` and ``grad: r2:``.  It depends only on the
    spec and the leaf's constants, not on its axes or metric."""
    return _radial(leaf, namespace)[0]


def radial_ops(leaf):
    """``(value, slope)``: primal operations of one ``radial_value`` and one
    ``radial_slope`` as generated (each ``exp`` / ``sqrt`` / ``pow`` one)."""
    _, vops, sops = _radial(leaf, "radial")
    return vops, sops
