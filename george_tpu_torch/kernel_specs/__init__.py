# -*- coding: utf-8 -*-
"""The YAML kernel DSL specs, shipped as package data.

This package keeps its own copy of the specs (the bodies are plain
expressions that compile against a torch namespace, see
:mod:`george_tpu_torch.dsl.compiler`); they are loaded through
:mod:`importlib.resources` by :func:`george_tpu_torch.dsl.specs.load_specs`.
"""
