# -*- coding: utf-8 -*-
"""Kernel classes, synthesized at import time from the YAML DSL.

The concrete classes (ExpSquaredKernel, Matern32Kernel, ...) are generated
from ``kernel_specs/*.yml`` with george's constructor signatures and
composition semantics; every evaluation routes through the torch evaluators
in :mod:`george_tpu_torch.dsl.compiler`.

Semantics:
  * ``kernel + kernel`` / ``kernel * kernel`` build Sum/Product trees; adding
    or multiplying a scalar ``c`` promotes it to
    ``ConstantKernel(log_constant=log(c / ndim))`` so that the
    per-axis-summed constant equals ``c``;
  * stationary kernels take a ``metric`` (scalar / vector / matrix) and
    support per-axis ``block`` windows outside of which the kernel vanishes;
  * non-stationary kernels evaluate a scalar function on each axis of a
    ``Subspace`` and sum the results.
"""

import numpy as np
import torch

from ._device import resolve_device
from .modeling import Model, ModelSet
from .metrics import Metric, Subspace
from .dsl.specs import available_kernels
from .dsl import compiler
from .dsl.compiler import Leaf, Op

__all__ = ["Kernel", "Sum", "Product"]


class Kernel(ModelSet):
    """The abstract kernel type; all kernels are subclasses of this."""

    is_kernel = True
    kernel_type = -1

    # Keep numpy out of our operator overloads: a bare ``np.float64 * kernel``
    # must defer to ``Kernel.__rmul__`` instead of ufunc broadcasting over the
    # parameter vector.
    __array_ufunc__ = None
    __array_priority__ = np.inf

    # -- composition --------------------------------------------------------

    def __add__(self, other):
        if not hasattr(other, "is_kernel"):
            log_c = np.log(float(other) / self.ndim)
            return Sum(
                ConstantKernel(log_constant=log_c, ndim=self.ndim), self
            )
        return Sum(self, other)

    def __radd__(self, other):
        return self.__add__(other)

    def __mul__(self, other):
        if not hasattr(other, "is_kernel"):
            log_c = np.log(float(other) / self.ndim)
            return Product(
                ConstantKernel(log_constant=log_c, ndim=self.ndim), self
            )
        return Product(self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    # -- ModelSet plumbing ----------------------------------------------------

    def __getattr__(self, name):
        models = self.__dict__.get("models")
        if models is not None:
            if name in models:
                return models[name]
            if None in models:
                return getattr(models[None], name)
        raise AttributeError(name)

    def __getstate__(self):
        return self.__dict__.copy()

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __repr__(self):
        base = self.models[None]
        parts = [
            "{0}={1}".format(k, getattr(base, k)) for k in base.parameter_names
        ]
        if self.stationary:
            parts += [
                "metric={0}".format(repr(self.metric)),
                "block={0}".format(repr(self.block)),
            ]
        else:
            parts += [
                "ndim={0}".format(self.ndim),
                "axes={0}".format(repr(self.axes)),
            ]
        return "{0}({1})".format(type(self).__name__, ", ".join(parts))

    # -- compiled evaluation ---------------------------------------------------

    def spec_node(self):
        """The static, hashable expression-tree node for the compiler."""
        raise NotImplementedError

    def _as_coords(self, x, device, dtype=torch.float64):
        x = np.ascontiguousarray(x, dtype=np.float64)
        if x.ndim != 2 or x.shape[1] != self.ndim:
            raise ValueError("Dimension mismatch")
        return torch.as_tensor(x, device=device).to(dtype)

    def value_tensor(self, x1, x2=None, diag=False, device=None,
                     dtype=torch.float64):
        """:meth:`get_value` as a tensor on ``device`` in ``dtype`` (the
        build the GP uses for its cross and prior matrices)."""
        device = resolve_device(device)
        x1 = self._as_coords(x1, device, dtype)
        x2 = x1 if x2 is None else self._as_coords(x2, device, dtype)
        node = self.spec_node()
        theta = torch.as_tensor(
            self.get_parameter_vector(include_frozen=True), device=device
        ).to(dtype)
        fn = compiler.kernel_diag_fn if diag else compiler.kernel_value_fn
        with torch.no_grad():
            return fn(node)(theta, x1, x2)

    def _gradient(self, make, x1, x2, device, dtype):
        device = resolve_device(device)
        x1 = self._as_coords(x1, device, dtype)
        x2 = x1 if x2 is None else self._as_coords(x2, device, dtype)
        theta = torch.as_tensor(
            self.get_parameter_vector(include_frozen=True), device=device
        ).to(dtype)
        return make(self.spec_node())(theta, x1, x2).cpu().numpy()

    def get_gradient(self, x1, x2=None, include_frozen=False, device=None,
                     dtype=torch.float64):
        """Hyperparameter gradient tensor, (N1, N2, n_active) (numpy);
        ``include_frozen`` keeps every parameter."""
        mask = (np.ones(self.full_size, dtype=bool) if include_frozen
                else self.unfrozen_mask)
        return self._gradient(compiler.kernel_gradient_fn, x1, x2, device,
                              dtype)[:, :, mask]

    def get_x1_gradient(self, x1, x2=None, device=None, dtype=torch.float64):
        """``d k(x1_i, x2_j) / d x1_i``, (N1, N2, ndim) (numpy)."""
        return self._gradient(compiler.kernel_x1_gradient_fn, x1, x2,
                              device, dtype)

    def get_x2_gradient(self, x1, x2=None, device=None, dtype=torch.float64):
        """``d k(x1_i, x2_j) / d x2_j``, (N1, N2, ndim) (numpy)."""
        return self._gradient(compiler.kernel_x2_gradient_fn, x1, x2,
                              device, dtype)

    # -- finite-difference self tests ------------------------------------------

    def test_gradient(self, x1, x2=None, eps=1.32e-6, device=None,
                      **kwargs):
        """Assert :meth:`get_gradient` against centred differences of
        :meth:`get_value` (``kwargs`` go to ``np.allclose``)."""
        vector = self.get_parameter_vector()
        g0 = self.get_gradient(x1, x2=x2, device=device)
        for i, v in enumerate(vector):
            vector[i] = v + eps
            self.set_parameter_vector(vector)
            kp = self.get_value(x1, x2=x2, device=device)
            vector[i] = v - eps
            self.set_parameter_vector(vector)
            km = self.get_value(x1, x2=x2, device=device)
            vector[i] = v
            self.set_parameter_vector(vector)
            fd = 0.5 * (kp - km) / eps
            assert np.allclose(g0[:, :, i], fd, **kwargs), (
                "incorrect gradient for parameter '{0}' ({1})".format(
                    self.get_parameter_names()[i], i))

    def test_x1_gradient(self, x1, x2=None, eps=1.32e-6, device=None,
                         **kwargs):
        """Assert :meth:`get_x1_gradient` against centred differences."""
        kwargs.setdefault("atol", 0.5 * eps)
        g0 = self.get_x1_gradient(x1, x2=x2, device=device)
        if x2 is None:
            x2 = np.array(x1)
        for i in range(len(x1)):
            for k in range(self.ndim):
                x1[i, k] += eps
                kp = self.get_value(x1, x2=x2, device=device)
                x1[i, k] -= 2 * eps
                km = self.get_value(x1, x2=x2, device=device)
                x1[i, k] += eps
                fd = 0.5 * (kp - km) / eps
                assert np.allclose(g0[i, :, k], fd[i], **kwargs)

    def test_x2_gradient(self, x1, x2=None, eps=1.32e-6, device=None,
                         **kwargs):
        """Assert :meth:`get_x2_gradient` against centred differences."""
        kwargs.setdefault("atol", 0.5 * eps)
        g0 = self.get_x2_gradient(x1, x2=x2, device=device)
        if x2 is None:
            x2 = np.array(x1)
        for i in range(len(x2)):
            for k in range(self.ndim):
                x2[i, k] += eps
                kp = self.get_value(x1, x2=x2, device=device)
                x2[i, k] -= 2 * eps
                km = self.get_value(x1, x2=x2, device=device)
                x2[i, k] += eps
                fd = 0.5 * (kp - km) / eps
                assert np.allclose(g0[:, i, k], fd[:, i], **kwargs)

    def get_value(self, x1, x2=None, diag=False, device=None,
                  dtype=torch.float64):
        """Evaluate the covariance between sets of points (numpy).

        ``get_value(x)`` -> the symmetric (N, N) matrix; ``get_value(x1, x2)``
        -> the (N1, N2) cross matrix; ``diag=True`` -> the row-wise values.
        Runs on ``device`` (default: the CUDA card) in ``dtype`` (default
        float64).
        """
        return self.value_tensor(x1, x2, diag, device, dtype) \
            .cpu().numpy().copy()


class _operator(Kernel):
    """Base for binary kernel compositions."""

    is_kernel = False
    kernel_type = -1
    operator_type = -1
    stationary = False

    def __init__(self, k1, k2):
        if k1.ndim != k2.ndim:
            raise ValueError("Dimension mismatch")
        self.ndim = k1.ndim
        self._dirty = True
        super(_operator, self).__init__([("k1", k1), ("k2", k2)])

    @property
    def k1(self):
        return self.models["k1"]

    @property
    def k2(self):
        return self.models["k2"]

    @property
    def dirty(self):
        return self._dirty or self.k1.dirty or self.k2.dirty

    @dirty.setter
    def dirty(self, v):
        self._dirty = v
        self.k1.dirty = False
        self.k2.dirty = False


class Sum(_operator):
    is_kernel = False
    operator_type = 0

    def spec_node(self):
        return Op("sum", self.k1.spec_node(), self.k2.spec_node())

    def __repr__(self):
        return "{0} + {1}".format(self.k1, self.k2)


class Product(_operator):
    is_kernel = False
    operator_type = 1

    def spec_node(self):
        return Op("product", self.k1.spec_node(), self.k2.spec_node())

    def __repr__(self):
        return "{0} * {1}".format(self.k1, self.k2)


# ---------------------------------------------------------------------------
# Concrete-class synthesis from the DSL.
# ---------------------------------------------------------------------------

def _set_constants(self, constants):
    for name, value in constants.items():
        if value is None:
            raise ValueError(
                "missing required parameter '{0}'".format(name)
            )
        setattr(self, name, float(value))


def _init_stationary(self, spec, params, constants, metric, metric_bounds,
                     lower, block, bounds, ndim, axes):
    _set_constants(self, constants)
    if metric is None:
        raise ValueError("missing required parameter 'metric'")
    metric = Metric(
        metric, bounds=metric_bounds, ndim=ndim, axes=axes, lower=lower
    )
    self.ndim = metric.ndim
    self.axes = metric.axes
    self.block = block
    kwargs = dict(params)
    if bounds is not None:
        kwargs["bounds"] = bounds
    base = self._base_class(**kwargs)
    ModelSet.__init__(self, [(None, base), ("metric", metric)])
    self.dirty = True


def _init_subspace(self, spec, params, constants, bounds, ndim, axes):
    _set_constants(self, constants)
    self.subspace = Subspace(ndim, axes=axes)
    self.ndim = self.subspace.ndim
    self.axes = self.subspace.axes
    kwargs = dict(params)
    if bounds is not None:
        kwargs["bounds"] = bounds
    base = self._base_class(**kwargs)
    ModelSet.__init__(self, [(None, base)])
    self.dirty = True


def _constants_tuple(self):
    return tuple((c, float(getattr(self, c))) for c in self._constant_names)


def _stationary_spec_node(self):
    metric = self.models["metric"]
    return Leaf(
        name=self._spec_name,
        constants=_constants_tuple(self),
        ndim=int(self.ndim),
        axes=tuple(int(a) for a in self.axes),
        stationary=True,
        nparams=len(self._param_names),
        metric_type=int(metric.metric_type),
        nmetric=int(metric.full_size),
        blocked=bool(self.blocked),
        min_block=tuple(float(v) for v in self.min_block),
        max_block=tuple(float(v) for v in self.max_block),
    )


def _subspace_spec_node(self):
    return Leaf(
        name=self._spec_name,
        constants=_constants_tuple(self),
        ndim=int(self.ndim),
        axes=tuple(int(a) for a in self.axes),
        stationary=False,
        nparams=len(self._param_names),
    )


def _block_get(self):
    if not self.blocked:
        return None
    return list(zip(self.min_block, self.max_block))


def _block_set(self, block):
    naxes = len(self.axes)
    if block is None:
        self.blocked = False
        self.min_block = np.full(naxes, -np.inf)
        self.max_block = np.full(naxes, np.inf)
        return
    block = np.atleast_2d(block)
    if block.shape != (naxes, 2):
        raise ValueError("dimension mismatch in block specification")
    self.blocked = True
    self.min_block, self.max_block = map(np.array, zip(*block))


def _render_init(spec):
    """Exec a thin __init__ with george's constructor signature."""
    args = ["{0}=None".format(p) for p in spec.params]
    args += ["{0}=None".format(c) for c in spec.constant_names]
    if spec.stationary:
        args += ["metric=None", "metric_bounds=None", "lower=True",
                 "block=None"]
    args += ["bounds=None", "ndim=1", "axes=None"]
    params_dict = ", ".join("{0}={0}".format(p) for p in spec.params)
    consts_dict = ", ".join("{0}={0}".format(c) for c in spec.constant_names)
    if spec.stationary:
        body = (
            "    _init_stationary(self, _spec, dict({0}), dict({1}), metric,"
            " metric_bounds, lower, block, bounds, ndim, axes)"
        ).format(params_dict, consts_dict)
    else:
        body = (
            "    _init_subspace(self, _spec, dict({0}), dict({1}), bounds,"
            " ndim, axes)"
        ).format(params_dict, consts_dict)
    src = "def __init__(self, {0}):\n{1}\n".format(", ".join(args), body)
    ns = {
        "_init_stationary": _init_stationary,
        "_init_subspace": _init_subspace,
        "_spec": spec,
    }
    exec(src, ns)
    return ns["__init__"]


def _make_kernel_class(spec):
    base_model = type(
        "Base" + spec.name, (Model,), {"parameter_names": tuple(spec.params)}
    )
    attrs = {
        "__doc__": spec.doc,
        "__init__": _render_init(spec),
        "kernel_type": spec.kernel_type,
        "stationary": spec.stationary,
        "_spec_name": spec.name,
        "_param_names": tuple(spec.params),
        "_constant_names": spec.constant_names,
        "_base_class": base_model,
    }
    if spec.stationary:
        attrs["spec_node"] = _stationary_spec_node
        attrs["block"] = property(_block_get, _block_set)
    else:
        attrs["spec_node"] = _subspace_spec_node
    return type(spec.name, (Kernel,), attrs)


def _register_all():
    module = globals()
    for spec in available_kernels().values():
        cls = _make_kernel_class(spec)
        module[spec.name] = cls
        # Register the Base model class too so instances pickle cleanly.
        module[cls._base_class.__name__] = cls._base_class
        __all__.append(spec.name)


_register_all()
