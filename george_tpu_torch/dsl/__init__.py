# -*- coding: utf-8 -*-
"""The YAML kernel DSL: spec loading and compilation to torch functions."""

from .specs import KernelSpec, available_kernels, load_specs

__all__ = ["KernelSpec", "available_kernels", "load_specs"]
