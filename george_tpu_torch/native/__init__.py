# -*- coding: utf-8 -*-
"""The native (C++) point orderings, loaded over a C ABI by ctypes.

``src/ordering.cpp`` is built with ``g++ -O3`` at first use into the
package's build directory (``build/george_tpu_torch/``, beside the CUDA
libraries), under a name that hashes the source and the flags, so a changed
source never loads a stale library.  A failed build raises: there is no
other implementation.  Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from .._build import build_dir

__all__ = ["distance_order", "kd_order", "hilbert_order", "load"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                    "ordering.cpp")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lib = None
_lock = threading.Lock()


def _library_path():
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update("\0".join(_FLAGS).encode())
    return os.path.join(build_dir(), "ordering_{0}.so".format(
        h.hexdigest()[:16]))


def _build(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # Unique per process and thread; the rename makes the library appear
    # whole or not at all.
    tmp = "{0}.tmp{1}_{2}".format(path, os.getpid(), threading.get_ident())
    proc = subprocess.run(["g++"] + _FLAGS + [_SRC, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("g++ failed to build {0}:\n{1}".format(
            _SRC, proc.stderr))
    os.replace(tmp, path)


def load():
    """The loaded ordering library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            path = _library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            for name in ("gt_distance_order", "gt_kd_order"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_void_p]
            lib.gt_hilbert_order.restype = ctypes.c_int
            lib.gt_hilbert_order.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_void_p]
            _lib = lib
    return _lib


def _order(name, samples, *extra):
    samples = np.ascontiguousarray(np.atleast_2d(samples), dtype=np.float64)
    n, d = samples.shape
    out = np.empty(n, dtype=np.int64)
    rc = getattr(load(), name)(samples.ctypes.data, n, d, *extra,
                               out.ctypes.data)
    if rc != 0:
        raise ValueError("{0} rejected samples of shape {1}".format(
            name, samples.shape))
    return out


def distance_order(samples):
    """Indices ordering samples by distance from ``samples[0]``."""
    return _order("gt_distance_order", samples)


def kd_order(samples):
    """Recursive median-split (k-d) ordering: at every level the two halves
    of the order are spatially separated clusters."""
    return _order("gt_kd_order", samples)


def hilbert_order(samples, bits=16):
    """Hilbert space-filling-curve ordering."""
    return _order("gt_hilbert_order", samples, bits)
