# -*- coding: utf-8 -*-
"""Loading of the YAML kernel DSL.

Schema: ``name``, ``kernel_type``, ``stationary``, ``params``, ``constants``,
``reparams``, ``value``, ``grad``, ``imports``, ``doc``.  Expression bodies
are Python expressions over a small math namespace (compiled to torch
functions by :mod:`george_tpu_torch.dsl.compiler`); every spec pins an
explicit ``kernel_type`` id.

The ``grad: r2`` entries are authoritative for the radial derivative of
stationary kernels (autodiff through ``sqrt(r2)`` is NaN at r2 = 0).
"""

import glob
import os
from dataclasses import dataclass
from importlib import resources
from typing import Dict, Tuple

import yaml

__all__ = ["KernelSpec", "load_specs", "available_kernels"]

# The built-in specs ship as package data; extra spec directories
# (colon-separated) may be supplied through the environment.
_SPEC_PACKAGE = "george_tpu_torch.kernel_specs"


def _extra_search_paths():
    env = os.environ.get("GEORGE_TPU_KERNEL_PATH")
    return env.split(":") if env else []


@dataclass(frozen=True)
class KernelSpec:
    """A parsed, immutable kernel definition."""

    name: str
    kernel_type: int
    stationary: bool
    params: Tuple[str, ...] = ()
    constants: Tuple[Tuple[str, str], ...] = ()  # (name, type)
    reparams: Tuple[Tuple[str, str], ...] = ()   # (name, expression)
    value: str = "0.0"
    grad: Tuple[Tuple[str, str], ...] = ()       # (wrt, expression)
    imports: Tuple[str, ...] = ()                # "module.path:name" extras
    doc: str = ""

    @property
    def grad_dict(self) -> Dict[str, str]:
        return dict(self.grad)

    @property
    def reparam_dict(self) -> Dict[str, str]:
        return dict(self.reparams)

    @property
    def constant_names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.constants)


def _parse_spec(raw: dict, origin: str) -> KernelSpec:
    for key in ("name", "kernel_type", "value"):
        if key not in raw:
            raise ValueError(
                "kernel spec {0} is missing required field '{1}'".format(
                    origin, key
                )
            )
    constants = tuple(
        (c["name"], c.get("type", "float")) for c in raw.get("constants", [])
    )
    return KernelSpec(
        name=str(raw["name"]),
        kernel_type=int(raw["kernel_type"]),
        stationary=bool(raw.get("stationary", False)),
        params=tuple(raw.get("params", []) or []),
        constants=constants,
        reparams=tuple(sorted((raw.get("reparams", {}) or {}).items())),
        value=str(raw["value"]).strip(),
        grad=tuple(sorted(
            (k, str(v).strip()) for k, v in (raw.get("grad", {}) or {}).items()
        )),
        imports=tuple(raw.get("imports", []) or []),
        doc=str(raw.get("doc", "")),
    )


def _iter_spec_sources(extra_paths):
    """Yield ``(origin, text)`` for every spec on the search path."""
    pkg = resources.files(_SPEC_PACKAGE)
    for entry in sorted(pkg.iterdir(), key=lambda p: p.name):
        if entry.name.endswith(".yml"):
            yield "{0}/{1}".format(_SPEC_PACKAGE, entry.name), \
                entry.read_text()
    for root in list(_extra_search_paths()) + list(extra_paths):
        for path in sorted(glob.glob(os.path.join(root, "*.yml"))):
            with open(path) as f:
                yield path, f.read()


def load_specs(extra_paths=()) -> Dict[str, KernelSpec]:
    """Load every ``*.yml`` kernel spec on the search path, keyed by name."""
    specs: Dict[str, KernelSpec] = {}
    ids = {}
    for origin, text in _iter_spec_sources(extra_paths):
        spec = _parse_spec(yaml.safe_load(text), origin)
        if spec.kernel_type in ids and ids[spec.kernel_type] != spec.name:
            raise ValueError(
                "duplicate kernel_type {0} ({1} vs {2})".format(
                    spec.kernel_type, ids[spec.kernel_type], spec.name
                )
            )
        ids[spec.kernel_type] = spec.name
        specs[spec.name] = spec
    return specs


_CACHE = None


def available_kernels() -> Dict[str, KernelSpec]:
    """Cached view of all registered kernel specs."""
    global _CACHE
    if _CACHE is None:
        _CACHE = load_specs()
    return _CACHE
