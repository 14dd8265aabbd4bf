# -*- coding: utf-8 -*-
"""Named-parameter modeling protocol.

This module implements the host-side parameter-management protocol that the
whole framework is built on: named parameters, freeze/thaw ("active set"),
bounds with a flat prior, and colon-namespaced composition of sub-models.

The protocol is API-compatible with george's modeling layer, so that user
code written against it keeps working.  It is *pure host-side bookkeeping*
(numpy only): all heavy numerics live in torch functions that consume flat
parameter vectors extracted through this layer (see
:mod:`george_tpu_torch.dsl.compiler` and :mod:`george_tpu_torch.gp`).  This
module is kept line for line in step with the JAX package's ``modeling.py``,
so parameter names, vectors and masks are interchangeable between the two.

Semantics kept from george:
  * freeze/thaw and ``unfrozen_mask``;
  * a forward-difference default gradient with EPS=1.254e-5;
  * a flat ``log_prior`` that rejects out-of-bounds vectors;
  * colon-namespaced ``ModelSet`` names ("model1:par1").
"""

from collections import OrderedDict

import numpy as np

__all__ = ["Model", "ModelSet", "ConstantModel", "CallableModel"]

# Forward-difference step used by the default numerical gradient.  The value
# matches george's, so that finite-difference fallbacks agree bit-for-bit.
_FD_EPS = 1.254e-5


class Model(object):
    """Abstract base class implementing the modeling protocol.

    Subclasses declare ``parameter_names`` (a tuple of strings) and implement
    :meth:`get_value`.  Parameter values can be passed positionally (in
    ``parameter_names`` order) or by keyword; bounds may be passed as a
    ``bounds`` keyword (a dict keyed by name, or a list of ``(min, max)``
    pairs with length ``full_size``).
    """

    parameter_names = tuple()

    def __init__(self, *args, **kwargs):
        self.unfrozen_mask = np.ones(self.full_size, dtype=bool)
        self.dirty = True
        self.parameter_bounds = self._parse_bounds(kwargs.pop("bounds", {}))

        if args:
            if len(args) != self.full_size:
                raise ValueError(
                    "expected {0} arguments but got {1}".format(
                        self.full_size, len(args)
                    )
                )
            if any(k in kwargs for k in self.parameter_names):
                raise ValueError(
                    "parameters must be fully specified by arguments or "
                    "keyword arguments, not both"
                )
            self.parameter_vector = args
        else:
            values = []
            for name in self.parameter_names:
                v = kwargs.pop(name, None)
                if v is None:
                    raise ValueError("missing parameter '{0}'".format(name))
                values.append(v)
            self.parameter_vector = values
            unknown = [k for k in kwargs if k != "quiet"]
            if unknown:
                raise ValueError(
                    "unrecognized parameter(s) '{0}'".format(unknown)
                )

        if not kwargs.get("quiet", False) and not np.isfinite(self.log_prior()):
            raise ValueError("non-finite log prior value")

    def _parse_bounds(self, bounds):
        if hasattr(bounds, "get"):
            out = [bounds.get(k, (None, None)) for k in self.parameter_names]
        else:
            out = list(bounds)
        if len(out) != self.full_size:
            raise ValueError(
                "the number of bounds must equal the number of parameters"
            )
        for b in out:
            try:
                if len(b) != 2:
                    raise ValueError
            except (TypeError, ValueError):
                raise ValueError(
                    "the bounds for each parameter must have the format: "
                    "'(min, max)'"
                )
        return out

    # -- evaluation interface -------------------------------------------------

    def get_value(self, *args, **kwargs):
        """Evaluate the model at the current parameters (overload me)."""
        raise NotImplementedError("overloaded by subclasses")

    def compute_gradient(self, *args, **kwargs):
        """Gradient of :meth:`get_value` w.r.t. the *full* parameter vector.

        Default: first-order forward differences (step matches the reference,
        src/george/modeling.py:117).  Subclasses should override with an
        analytic (or autodiff) gradient.  The leading dimension of the result
        is ``full_size``.
        """
        vec = self.get_parameter_vector()
        f0 = self.get_value(*args, **kwargs)
        out = np.empty([len(vec)] + list(np.shape(f0)), dtype=np.float64)
        for i, v in enumerate(vec):
            vec[i] = v + _FD_EPS
            self.set_parameter_vector(vec)
            out[i] = (self.get_value(*args, **kwargs) - f0) / _FD_EPS
            vec[i] = v
            self.set_parameter_vector(vec)
        return out

    def get_gradient(self, *args, **kwargs):
        include_frozen = kwargs.pop("include_frozen", False)
        g = self.compute_gradient(*args, **kwargs)
        return g if include_frozen else g[self.unfrozen_mask]

    # -- sizes ----------------------------------------------------------------

    @property
    def full_size(self):
        """Total number of parameters, frozen ones included."""
        return len(self.parameter_names)

    @property
    def vector_size(self):
        """Number of active (unfrozen) parameters."""
        return int(self.unfrozen_mask.sum())

    def __len__(self):
        return self.vector_size

    # -- the parameter vector ------------------------------------------------

    @property
    def parameter_vector(self):
        """All parameter values (frozen included) as a float array."""
        return np.array(
            [getattr(self, k) for k in self.parameter_names], dtype=np.float64
        )

    @parameter_vector.setter
    def parameter_vector(self, values):
        values = list(values)
        if len(values) != self.full_size:
            raise ValueError("dimension mismatch")
        for name, v in zip(self.parameter_names, values):
            setattr(self, name, float(v))
        self.dirty = True

    def get_parameter_vector(self, include_frozen=False):
        if include_frozen:
            return self.parameter_vector
        return self.parameter_vector[self.unfrozen_mask]

    def set_parameter_vector(self, vector, include_frozen=False):
        v = self.parameter_vector
        if include_frozen:
            v[:] = vector
        else:
            v[self.unfrozen_mask] = vector
        self.parameter_vector = v
        self.dirty = True

    def check_parameter_vector(self, vector):
        """Check if ``vector`` satisfies the prior, without side effects."""
        saved = np.array(self.get_parameter_vector())
        saved_dirty = self.dirty
        self.set_parameter_vector(vector)
        ok = np.isfinite(self.log_prior())
        self.set_parameter_vector(saved)
        self.dirty = saved_dirty
        return ok

    # -- names, bounds, dicts -------------------------------------------------

    def get_parameter_names(self, include_frozen=False):
        if include_frozen:
            return self.parameter_names
        return tuple(
            n for n, f in zip(self.parameter_names, self.unfrozen_mask) if f
        )

    def get_parameter_bounds(self, include_frozen=False):
        if include_frozen:
            return self.parameter_bounds
        return [
            b for b, f in zip(self.parameter_bounds, self.unfrozen_mask) if f
        ]

    def get_parameter_dict(self, include_frozen=False):
        return OrderedDict(
            zip(
                self.get_parameter_names(include_frozen=include_frozen),
                self.get_parameter_vector(include_frozen=include_frozen),
            )
        )

    # -- named access ----------------------------------------------------------

    def _resolve_name(self, name_or_index):
        try:
            index = int(name_or_index)
        except (TypeError, ValueError):
            return name_or_index
        return self.get_parameter_names()[index]

    def __getitem__(self, name_or_index):
        return self.get_parameter(self._resolve_name(name_or_index))

    def __setitem__(self, name_or_index, value):
        self.set_parameter(self._resolve_name(name_or_index), value)

    def get_parameter(self, name):
        i = self.get_parameter_names(include_frozen=True).index(name)
        return self.get_parameter_vector(include_frozen=True)[i]

    def set_parameter(self, name, value):
        i = self.get_parameter_names(include_frozen=True).index(name)
        v = self.get_parameter_vector(include_frozen=True)
        v[i] = value
        self.set_parameter_vector(v, include_frozen=True)

    # -- freeze / thaw ----------------------------------------------------------

    def freeze_parameter(self, name):
        i = self.get_parameter_names(include_frozen=True).index(name)
        self.unfrozen_mask[i] = False

    def thaw_parameter(self, name):
        i = self.get_parameter_names(include_frozen=True).index(name)
        self.unfrozen_mask[i] = True

    def freeze_all_parameters(self):
        self.unfrozen_mask[:] = False

    def thaw_all_parameters(self):
        self.unfrozen_mask[:] = True

    # -- prior -------------------------------------------------------------------

    def log_prior(self):
        """Flat prior: 0 inside the bounds box, -inf outside."""
        for value, (lo, hi) in zip(self.parameter_vector,
                                   self.parameter_bounds):
            if lo is not None and value < lo:
                return -np.inf
            if hi is not None and value > hi:
                return -np.inf
        return 0.0

    # -- helpers -----------------------------------------------------------------

    @staticmethod
    def parameter_sort(f):
        """Decorator: sort a dict-valued gradient into parameter order."""

        def wrapped(self, *args, **kwargs):
            values = f(self, *args, **kwargs)
            names = self.get_parameter_names(include_frozen=True)
            out = [values[name] for name in names]
            if out and isinstance(out[0], np.ndarray):
                return np.vstack(out)
            return out

        return wrapped


class ModelSet(Model):
    """An ordered, named composition of :class:`Model` objects.

    Parameter names of submodels are namespaced as ``"<name>:<param>"``; a
    submodel registered under the name ``None`` contributes its parameter
    names without a prefix (used by kernels for their base parameters).
    """

    def __init__(self, models):
        self.models = OrderedDict(models)

    def __getattr__(self, name):
        models = self.__dict__.get("models")
        if models is not None and name in models:
            return models[name]
        raise AttributeError(name)

    # -- aggregated protocol ----------------------------------------------------

    @property
    def dirty(self):
        return any(m.dirty for m in self.models.values())

    @dirty.setter
    def dirty(self, value):
        for m in self.models.values():
            m.dirty = value

    @property
    def full_size(self):
        return sum(m.full_size for m in self.models.values())

    @property
    def vector_size(self):
        return sum(m.vector_size for m in self.models.values())

    @property
    def unfrozen_mask(self):
        return np.concatenate(
            [m.unfrozen_mask for m in self.models.values()]
        ) if self.models else np.ones(0, dtype=bool)

    @property
    def parameter_names(self):
        names = []
        for name, model in self.models.items():
            if name is None:
                names.extend(model.parameter_names)
            else:
                names.extend(
                    "{0}:{1}".format(name, p) for p in model.parameter_names
                )
        return tuple(names)

    @property
    def parameter_bounds(self):
        out = []
        for m in self.models.values():
            out.extend(m.parameter_bounds)
        return out

    @property
    def parameter_vector(self):
        if not self.models:
            return np.zeros(0)
        return np.concatenate(
            [m.parameter_vector for m in self.models.values()]
        )

    @parameter_vector.setter
    def parameter_vector(self, v):
        i = 0
        for m in self.models.values():
            n = m.full_size
            m.parameter_vector = v[i:i + n]
            i += n

    # -- name routing --------------------------------------------------------------

    def _route(self, method, name, *args):
        head, _, rest = name.partition(":")
        if head not in self.models:
            if None in self.models:
                head, rest = None, name
            else:
                raise ValueError("unrecognized parameter '{0}'".format(name))
        return getattr(self.models[head], method)(rest, *args)

    def freeze_parameter(self, name):
        self._route("freeze_parameter", name)

    def thaw_parameter(self, name):
        self._route("thaw_parameter", name)

    def freeze_all_parameters(self):
        for m in self.models.values():
            m.freeze_all_parameters()

    def thaw_all_parameters(self):
        for m in self.models.values():
            m.thaw_all_parameters()

    def get_parameter(self, name):
        return self._route("get_parameter", name)

    def set_parameter(self, name, value):
        self.dirty = True
        return self._route("set_parameter", name, value)

    def log_prior(self):
        total = 0.0
        for m in self.models.values():
            total += m.log_prior()
            if not np.isfinite(total):
                return -np.inf
        return total


class ConstantModel(Model):
    """A model with a single parameter, ``value``, constant over inputs."""

    parameter_names = ("value",)

    def get_value(self, x):
        return self.value + np.zeros(len(x))

    def compute_gradient(self, x):
        return np.ones((1, len(x)))


class CallableModel(Model):
    """Wrap a plain function (with optional gradient) as a zero-parameter
    model."""

    def __init__(self, function, gradient=None):
        self.function = function
        self.gradient = gradient
        super(CallableModel, self).__init__()

    def get_value(self, x):
        return self.function(x)

    def compute_gradient(self, x):
        if self.gradient is not None:
            return self.gradient(x)
        return super(CallableModel, self).compute_gradient(x)
