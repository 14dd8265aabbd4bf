# -*- coding: utf-8 -*-
"""Build the hand-written CUDA kernels with ``nvcc`` and load them by ctypes.

Each kernel source under ``csrc/`` has a plain C interface.  One shared
library is built per instantiation (a set of ``-D`` macros), at first use,
into the build directory, named by a hash of the source text and the full
flag list, so a changed source or flag set never loads a stale library.
Builds of several instantiations run in parallel (one ``nvcc`` each, all
started together).  Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

__all__ = ["build_dir", "build", "load", "ptxas_report"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v"]

_LOADED = {}


def build_dir():
    """``build/george_tpu_torch`` next to the package (the checkout's root
    when run from a checkout)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, "build", "george_tpu_torch")


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _key(source, defines):
    return (source, tuple(sorted(defines.items())))


def _paths(source, defines):
    src = os.path.join(_CSRC, source)
    with open(src, "rb") as f:
        text = f.read()
    flags = _ARCH + _FLAGS + ["-D{0}={1}".format(k, v)
                              for k, v in sorted(defines.items())]
    digest = hashlib.sha256(text + "\0".join(flags).encode()).hexdigest()
    stem = os.path.join(build_dir(), "{0}_{1}".format(
        os.path.splitext(source)[0], digest[:16]))
    return src, flags, stem + ".so", stem + ".log"


def build(source, defines_list):
    """Build every instantiation of ``source`` not yet on disk, in parallel.

    :param defines_list: iterable of dicts of ``-D`` macros.
    :returns: the list of library paths, in order.
    """
    os.makedirs(build_dir(), exist_ok=True)
    jobs, libs = [], []
    for defines in defines_list:
        src, flags, lib, log = _paths(source, defines)
        libs.append(lib)
        if os.path.exists(lib) or any(j[1] == lib for j in jobs):
            continue
        tmp = "{0}.tmp{1}".format(lib, os.getpid())
        cmd = [_nvcc()] + flags + ["-o", tmp, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        jobs.append((proc, lib, log, tmp, cmd))
    failures = []
    for proc, lib, log, tmp, cmd in jobs:
        out, _ = proc.communicate()
        with open(log, "wb") as f:
            f.write(out)
        if proc.returncode != 0:
            failures.append("{0}\n{1}".format(" ".join(cmd),
                                              out.decode(errors="replace")))
            continue
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return libs


def load(source, defines):
    """The loaded library of one instantiation (built on first use)."""
    key = _key(source, defines)
    lib = _LOADED.get(key)
    if lib is None:
        path = build(source, [defines])[0]
        lib = ctypes.CDLL(path)
        _LOADED[key] = lib
    return lib


def ptxas_report(source, defines):
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of a
    built instantiation."""
    _, _, _, log = _paths(source, defines)
    with open(log, errors="replace") as f:
        return [line.strip() for line in f
                if "ptxas info" in line or "bytes stack frame" in line]
